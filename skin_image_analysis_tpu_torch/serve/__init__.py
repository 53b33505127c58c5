"""Serving (port of the JAX package's ``serve``): the inference program
and its ``torch.export`` artifact, and the online HTTP server with
bucketed dynamic batching. Quantization and the serving trace are not
ported yet (ROADMAP queue 1 item 10 part 2)."""

from skin_image_analysis_tpu_torch.serve.export import (  # noqa: F401
    build_infer_fn,
    build_infer_fn_weights_arg,
    export_model,
    load_exported,
    predict_exported,
)
from skin_image_analysis_tpu_torch.serve.server import (  # noqa: F401
    DynamicBatcher,
    InferenceSession,
    make_http_server,
    serve_http,
)

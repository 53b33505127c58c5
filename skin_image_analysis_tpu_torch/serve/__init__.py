"""Serving (port of the JAX package's ``serve``): the inference program
and its ``torch.export`` artifact, the online HTTP server with bucketed
dynamic batching, int8 post-training quantization and the graph capture
it runs on."""

from skin_image_analysis_tpu_torch.serve.export import (  # noqa: F401
    build_infer_fn,
    build_infer_fn_weights_arg,
    export_model,
    load_exported,
    predict_exported,
)
from skin_image_analysis_tpu_torch.serve.quantize import (  # noqa: F401
    build_infer_fn_quantized,
    quantization_report,
    quantize_model,
    quantized_forward,
)
from skin_image_analysis_tpu_torch.serve.server import (  # noqa: F401
    DynamicBatcher,
    InferenceSession,
    make_http_server,
    serve_http,
)

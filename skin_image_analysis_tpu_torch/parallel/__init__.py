from skin_image_analysis_tpu_torch.parallel.mesh import create_mesh  # noqa: F401
from skin_image_analysis_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    infer_param_shardings,
    replicated,
)

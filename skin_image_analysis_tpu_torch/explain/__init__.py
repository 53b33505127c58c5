from skin_image_analysis_tpu_torch.explain.attribution import (  # noqa: F401
    grad_cam,
    grad_cam_gap_head,
    gradient_shap,
    integrated_gradients,
    saliency,
    smoothgrad,
)
from skin_image_analysis_tpu_torch.explain.occlusion import occlusion_map  # noqa: F401

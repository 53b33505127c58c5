from skin_image_analysis_tpu_torch.ops.losses import nll_loss  # noqa: F401

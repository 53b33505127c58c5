"""The hand-written CUDA kernels' wrappers and plain versions (the JAX
package's ``ops.pallas``)."""

from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess_planar  # noqa: F401

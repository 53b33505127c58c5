"""skin_image_analysis_tpu_torch — the PyTorch + CUDA port of
:mod:`skin_image_analysis_tpu` for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package mirrors its module
names (``config``, ``ops.preprocess``, ``ops.pooling``, ``models.cnn``,
``train.step``, ``train.loop``, ``metrics.*``) and imports nothing from it.
Every Pallas TPU kernel on the ported path is a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use (``ops.kernels.build``).
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from skin_image_analysis_tpu_torch import config as config  # noqa: F401

CLASS_NAMES = ("benign", "malignant")
"""Diagnosis classes; index 1 ('malignant') is the positive class."""

TONE_VALUES = ("light", "dark")
SEX_VALUES = ("male", "female")
CONTROL_VALUES = ("poor", "rich")

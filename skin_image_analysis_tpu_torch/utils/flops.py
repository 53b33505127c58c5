"""Contraction FLOPs of a model's forward (port of the JAX package's
``utils.flops``).

Counts the FLOPs of every convolution and matrix product one call runs,
with ``torch.utils.flop_counter.FlopCounterMode``; elementwise, pool and
normalisation work is not counted. This is the "useful matmul FLOPs"
numerator of an MFU share, and a train step is taken as about 3x the
forward (the activation- and weight-gradient products). The count follows
the lowering the model runs: the phase-packed 8x8/s2 conv for stem
"phase", the 5x5 conv over the space-to-depth layout for stem "s2d".
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

from skin_image_analysis_tpu_torch.config import ModelConfig


def contraction_flops(fn, *args: Any, **kwargs: Any) -> float:
    """Total conv and matmul FLOPs of one ``fn(*args, **kwargs)`` call.
    Pass tensors on the ``meta`` device to count without computing."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def forward_flops_per_img(model_cfg: ModelConfig,
                          batch_size: int = 8) -> float:
    """Forward contraction FLOPs per image of the model a config builds,
    at its configured size (eval forward), counted on meta tensors."""
    from skin_image_analysis_tpu_torch.models.cnn import build_model

    model = build_model(model_cfg, device="meta")
    side = model_cfg.image_size
    x = torch.empty((batch_size, side, side, model_cfg.in_channels),
                    device="meta")
    with torch.no_grad():
        return contraction_flops(model, x) / batch_size

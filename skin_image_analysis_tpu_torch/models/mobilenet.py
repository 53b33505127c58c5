"""MobileNetV2, weight-compatible with ``keras.applications.MobileNetV2``
(alpha 1.0; port of the JAX package's ``models.mobilenet``).

The reference's transfer recipe lists MobileNetV2 as a candidate
backbone. Inverted residual blocks with ReLU6 and linear projections,
Keras's table and names (``Conv1``, ``expanded_conv_*``, ``block_N_*``,
``Conv_1``), BatchNorm epsilon 1e-3:

- ``Conv1`` is a 3x3 stride-2 SAME conv, and every stride-2 depthwise
  conv pads as Keras's ``correct_pad`` + VALID, which is the same
  geometry: on an even side 0 before and 1 after (``models.resnet
  .same_pad``), where ``padding=1`` would shift every window;
- a block adds its input only at stride 1 with equal widths;
- ``Conv_1`` stays at 1280 features for alpha <= 1.

The head is the transfer recipe's (``models.transfer``); the Dense head
is ``head``. ``load_keras_mobilenet_v2_weights`` maps a Keras MobileNetV2
weights ``.h5`` (read with h5py) onto the port's ``state_dict``.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models.keras_io import (
    apply_name_identity_weights,
    read_legacy_h5,
)
from skin_image_analysis_tpu_torch.models.registry import register_model
from skin_image_analysis_tpu_torch.models.resnet import BatchNorm, Conv
from skin_image_analysis_tpu_torch.models.transfer import TransferBackbone

_BN_EPS = 1e-3  # Keras mobilenet_v2's BatchNormalization(epsilon=1e-3)

# (expansion t, filters c, repeats n, first stride s): Keras's table
_STAGES = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def make_divisible(v: float, divisor: int = 8) -> int:
    """Keras's ``_make_divisible``: round a width to the divisor, never
    dropping more than 10%."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MobileNetV2(TransferBackbone):
    """keras.applications.MobileNetV2 backbone + the transfer head. Input
    ``[B, H, W, C]`` floats; output ``[B, num_classes]`` float32
    log-probs."""

    def __init__(self, num_classes: int = 2, alpha: float = 1.0,
                 head_dropout: float = 0.5, compute_dtype: str = "bfloat16",
                 freeze_backbone: bool = False, in_channels: int = 3,
                 device=None):
        super().__init__()

        def conv_bn(name, bn_name, cin, cout, kernel=1, stride=1,
                    groups=1):
            setattr(self, name, Conv(cin, cout, kernel, stride,
                                     "same" if kernel > 1 else 0,
                                     compute_dtype, device, groups=groups))
            setattr(self, bn_name, BatchNorm(cout, compute_dtype,
                                             eps=_BN_EPS, device=device))

        first = make_divisible(32 * alpha)
        conv_bn("Conv1", "bn_Conv1", in_channels, first, 3, 2)
        # (name prefix, expands, adds its input)
        self.blocks: list[tuple[str, bool, bool]] = []
        filters_in = first
        for t, c, n, s in _STAGES:
            c_out = make_divisible(c * alpha)
            for i in range(n):
                stride = s if i == 0 else 1
                p = ("expanded_conv" if not self.blocks
                     else f"block_{len(self.blocks)}")
                filters = filters_in * t
                if t != 1:
                    conv_bn(f"{p}_expand", f"{p}_expand_BN", filters_in,
                            filters)
                conv_bn(f"{p}_depthwise", f"{p}_depthwise_BN", filters,
                        filters, 3, stride, groups=filters)
                conv_bn(f"{p}_project", f"{p}_project_BN", filters, c_out)
                self.blocks.append(
                    (p, t != 1, stride == 1 and filters_in == c_out))
                filters_in = c_out
        last = make_divisible(1280 * alpha) if alpha > 1.0 else 1280
        conv_bn("Conv_1", "Conv_1_bn", filters_in, last)
        self._transfer_head(last, num_classes, head_dropout, compute_dtype,
                            freeze_backbone, device)

    def _conv_bn(self, name: str, bn_name: str, x: torch.Tensor,
                 train: bool) -> torch.Tensor:
        return getattr(self, bn_name)(getattr(self, name)(x), train)

    def features(self, x: torch.Tensor, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.relu6(self._conv_bn("Conv1", "bn_Conv1", x, train))
        for p, expands, residual in self.blocks:
            y = x
            if expands:
                y = F.relu6(self._conv_bn(f"{p}_expand", f"{p}_expand_BN", y,
                                          train))
            y = F.relu6(self._conv_bn(f"{p}_depthwise", f"{p}_depthwise_BN",
                                      y, train))
            y = self._conv_bn(f"{p}_project", f"{p}_project_BN", y, train)
            x = y + x if residual else y
        return F.relu6(self._conv_bn("Conv_1", "Conv_1_bn", x, train))


@register_model("mobilenet_v2")
def _build_mobilenet_v2(cfg: ModelConfig, device=None) -> MobileNetV2:
    return MobileNetV2(cfg.num_classes, compute_dtype=cfg.compute_dtype,
                       freeze_backbone=cfg.freeze_backbone,
                       in_channels=cfg.in_channels, device=device)


def apply_keras_mobilenet_v2_weights(
    layer_names: list[str], weights_of: Callable[[str], Mapping],
    state_dict: Mapping[str, torch.Tensor],
) -> dict[str, torch.Tensor]:
    """The Keras -> port MobileNetV2 mapping: names are the identity; the
    ImageNet head (``predictions`` / ``Logits``) and preprocessing layers
    are skipped. Returns the updated copy of ``state_dict``."""
    return apply_name_identity_weights(
        layer_names, weights_of, state_dict,
        skip=("predictions", "Logits", "rescaling", "normalization"))


def load_keras_mobilenet_v2_weights(
    path: str, state_dict: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a legacy-format MobileNetV2 weights ``.h5`` (the downloadable
    ``mobilenet_v2_weights_tf_dim_ordering_tf_kernels_1.0_224_no_top.h5``
    layout) onto the port's ``state_dict`` and return the updated copy;
    h5py only."""
    layer_names, table = read_legacy_h5(path)
    return apply_keras_mobilenet_v2_weights(layer_names, table.__getitem__,
                                            state_dict)

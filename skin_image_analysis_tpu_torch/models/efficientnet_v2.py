"""EfficientNetV2 B0-B3, S, M and L, weight-compatible with
``keras.applications.EfficientNetV2B0`` ... ``EfficientNetV2L`` (port of
the JAX package's ``models.efficientnet_v2``).

The reference's transfer recipe lists EfficientNetV2B3 as a backbone
alternative. Keras's architecture exactly:

- early stages are Fused-MBConv (one full 3x3 conv in place of the
  depthwise + 1x1 pair), later ones MBConv with squeeze-excite (reducing
  from the block's input width, biased 1x1 convs);
- a fused block with expand ratio 1 is a single 3x3 ``project_conv``
  (with the stride) whose SiLU comes AFTER ``project_bn``; with expand >
  1 the 1x1 project has no activation;
- every conv is SAME, the stride-2 ones too: on an even side a 3x3
  stride-2 window pads 0 before and 1 after (``models.resnet
  .same_pad``), where ``padding=1`` would shift every window; the
  depthwise conv is ``dwconv2`` and its BatchNorm ``bn``;
- :func:`round_filters_v2` snaps to a multiple of 8 without v1's 90%
  bump; B0-B3 scale one table, S/M/L have their own (M and L a 7th
  stage);
- stochastic depth drops a residual block's branch per sample (a ``[B,
  1, 1, 1]`` mask) at ``drop_connect_rate * b / blocks``, where the
  counter ``b`` runs over the depth-scaled blocks and the denominator is
  the UNSCALED repeat sum, Keras's accounting (so B1-B3 rates pass
  ``drop_connect_rate`` near the tail); a block at rate 0 has no drop;
- SiLU everywhere, BatchNorm epsilon 1e-3; Keras's in-model Rescaling /
  Normalization is not part of the model.

Module names are the Keras layer names (``stem_conv``,
``block4a_dwconv2``, ``block6c_se_reduce``, ``top_bn``, ...), and the
Dense head is ``head``. ``load_keras_efficientnet_v2_weights`` maps a
Keras EfficientNetV2 weights ``.h5`` (read with h5py) onto the port's
``state_dict``.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple

import torch
import torch.nn.functional as F

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models.cnn import dropout
from skin_image_analysis_tpu_torch.models.keras_io import (
    apply_name_identity_weights,
    read_legacy_h5,
)
from skin_image_analysis_tpu_torch.models.registry import register_model
from skin_image_analysis_tpu_torch.models.resnet import BatchNorm, Conv
from skin_image_analysis_tpu_torch.models.transfer import (
    TransferBackbone,
    gap,
)

_BN_EPS = 1e-3  # Keras BatchNormalization's default

# (fused, expand_ratio, filters_in, filters_out, repeats, stride, se_ratio)
# per stage: Keras's DEFAULT_BLOCKS_ARGS; the first stage's filters_in is
# also the stem's width
_STAGES = {
    "b": (
        (True, 1, 32, 16, 1, 1, 0.0),
        (True, 4, 16, 32, 2, 2, 0.0),
        (True, 4, 32, 48, 2, 2, 0.0),
        (False, 4, 48, 96, 3, 2, 0.25),
        (False, 6, 96, 112, 5, 1, 0.25),
        (False, 6, 112, 192, 8, 2, 0.25),
    ),
    "s": (
        (True, 1, 24, 24, 2, 1, 0.0),
        (True, 4, 24, 48, 4, 2, 0.0),
        (True, 4, 48, 64, 4, 2, 0.0),
        (False, 4, 64, 128, 6, 2, 0.25),
        (False, 6, 128, 160, 9, 1, 0.25),
        (False, 6, 160, 256, 15, 2, 0.25),
    ),
    "m": (
        (True, 1, 24, 24, 3, 1, 0.0),
        (True, 4, 24, 48, 5, 2, 0.0),
        (True, 4, 48, 80, 5, 2, 0.0),
        (False, 4, 80, 160, 7, 2, 0.25),
        (False, 6, 160, 176, 14, 1, 0.25),
        (False, 6, 176, 304, 18, 2, 0.25),
        (False, 6, 304, 512, 5, 1, 0.25),
    ),
    "l": (
        (True, 1, 32, 32, 4, 1, 0.0),
        (True, 4, 32, 64, 7, 2, 0.0),
        (True, 4, 64, 96, 7, 2, 0.0),
        (False, 4, 96, 192, 10, 2, 0.25),
        (False, 6, 192, 224, 19, 1, 0.25),
        (False, 6, 224, 384, 25, 2, 0.25),
        (False, 6, 384, 640, 7, 1, 0.25),
    ),
}

# registered name -> (stage table, width_coefficient, depth_coefficient)
VARIANTS = {
    "efficientnet_v2_b0": ("b", 1.0, 1.0),
    "efficientnet_v2_b1": ("b", 1.0, 1.1),
    "efficientnet_v2_b2": ("b", 1.1, 1.2),
    "efficientnet_v2_b3": ("b", 1.2, 1.4),
    "efficientnet_v2_s": ("s", 1.0, 1.0),
    "efficientnet_v2_m": ("m", 1.0, 1.0),
    "efficientnet_v2_l": ("l", 1.0, 1.0),
}


def round_filters_v2(filters: float, width_coefficient: float,
                     divisor: int = 8) -> int:
    """Keras's V2 width scaling: the nearest multiple of ``divisor``, at
    least ``divisor``, without v1's 90% bump."""
    filters *= width_coefficient
    return int(max(divisor, int(filters + divisor / 2) // divisor * divisor))


def round_repeats_v2(repeats: int, depth_coefficient: float) -> int:
    return int(math.ceil(depth_coefficient * repeats))


def block_counts(variant: str) -> tuple[int, ...]:
    """Depth-scaled blocks per stage of a registered ``variant``."""
    table, _, d = VARIANTS[variant]
    return tuple(round_repeats_v2(row[4], d) for row in _STAGES[table])


class _Block(NamedTuple):
    name: str
    fused: bool
    expands: bool
    se: bool
    residual: bool
    drop_rate: float


class EfficientNetV2(TransferBackbone):
    """keras.applications.EfficientNetV2* backbone + the transfer head.
    Input ``[B, H, W, C]`` floats; output ``[B, num_classes]`` float32
    log-probs."""

    def __init__(self, num_classes: int = 2, table: str = "b",
                 width_coefficient: float = 1.0,
                 depth_coefficient: float = 1.0,
                 drop_connect_rate: float = 0.2, head_dropout: float = 0.5,
                 compute_dtype: str = "bfloat16",
                 freeze_backbone: bool = False, in_channels: int = 3,
                 device=None):
        super().__init__()
        stages = _STAGES[table]

        def rf(f):
            return round_filters_v2(f, width_coefficient)

        def conv_bn(name, bn_name, cin, cout, kernel, stride, groups=1):
            setattr(self, name, Conv(cin, cout, kernel, stride,
                                     "same" if kernel > 1 else 0,
                                     compute_dtype, device, groups=groups))
            setattr(self, bn_name, BatchNorm(cout, compute_dtype,
                                             eps=_BN_EPS, device=device))

        conv_bn("stem_conv", "stem_bn", in_channels, rf(stages[0][2]), 3, 2)
        # Keras's accounting: the unscaled repeat sum
        blocks_total = sum(row[4] for row in stages)
        self.blocks: list[_Block] = []
        for stage_i, (fused, expand, f_in, f_out, repeats, stride,
                      se_ratio) in enumerate(stages):
            f_in, f_out = rf(f_in), rf(f_out)
            for rep in range(round_repeats_v2(repeats, depth_coefficient)):
                p = f"block{stage_i + 1}{chr(ord('a') + rep)}"
                if rep > 0:
                    f_in, stride = f_out, 1
                filters = f_in * expand
                if expand != 1:
                    conv_bn(f"{p}_expand_conv", f"{p}_expand_bn", f_in,
                            filters, 3 if fused else 1,
                            stride if fused else 1)
                if not fused:
                    conv_bn(f"{p}_dwconv2", f"{p}_bn", filters, filters, 3,
                            stride, groups=filters)
                se = 0 < se_ratio <= 1
                if se:
                    se_filters = max(1, int(f_in * se_ratio))
                    for name, cin, cout in (
                            (f"{p}_se_reduce", filters, se_filters),
                            (f"{p}_se_expand", se_filters, filters)):
                        setattr(self, name, Conv(cin, cout, 1, 1, 0,
                                                 compute_dtype, device,
                                                 bias=True))
                if fused and expand == 1:
                    conv_bn(f"{p}_project_conv", f"{p}_project_bn", filters,
                            f_out, 3, stride)
                else:
                    conv_bn(f"{p}_project_conv", f"{p}_project_bn", filters,
                            f_out, 1, 1)
                rate = drop_connect_rate * len(self.blocks) / blocks_total
                self.blocks.append(_Block(p, fused, expand != 1, se,
                                          stride == 1 and f_in == f_out,
                                          rate))
        top = rf(1280)
        conv_bn("top_conv", "top_bn", rf(stages[-1][3]), top, 1, 1)
        self._transfer_head(top, num_classes, head_dropout, compute_dtype,
                            freeze_backbone, device)

    def drop_rates(self) -> dict[str, float]:
        """Each residual block's stochastic-depth rate, where it is above
        0 (the blocks that drop in training)."""
        return {b.name: b.drop_rate for b in self.blocks
                if b.residual and b.drop_rate > 0}

    def _conv_bn(self, name: str, bn_name: str, x: torch.Tensor,
                 train: bool) -> torch.Tensor:
        return getattr(self, bn_name)(getattr(self, name)(x), train)

    def features(self, x: torch.Tensor, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.silu(self._conv_bn("stem_conv", "stem_bn", x, train))
        for b in self.blocks:
            p = b.name
            y = x
            if b.expands:
                y = F.silu(self._conv_bn(f"{p}_expand_conv",
                                         f"{p}_expand_bn", y, train))
            if not b.fused:
                y = F.silu(self._conv_bn(f"{p}_dwconv2", f"{p}_bn", y,
                                         train))
            if b.se:
                se = F.silu(getattr(self, f"{p}_se_reduce")(
                    gap(y, keepdim=True)))
                y = y * torch.sigmoid(getattr(self, f"{p}_se_expand")(se))
            y = self._conv_bn(f"{p}_project_conv", f"{p}_project_bn", y,
                              train)
            if b.fused and not b.expands:
                y = F.silu(y)
            if b.residual:
                if train and b.drop_rate > 0:
                    y = dropout(y, b.drop_rate, generator,
                                shape=(y.shape[0], 1, 1, 1))
                y = y + x
            x = y
        return F.silu(self._conv_bn("top_conv", "top_bn", x, train))


def _register(name: str):
    @register_model(name)
    def _build(cfg: ModelConfig, device=None) -> EfficientNetV2:
        table, w, d = VARIANTS[name]
        return EfficientNetV2(cfg.num_classes, table, w, d,
                              compute_dtype=cfg.compute_dtype,
                              freeze_backbone=cfg.freeze_backbone,
                              in_channels=cfg.in_channels, device=device)

    return _build


for _name in VARIANTS:
    _register(_name)


def apply_keras_efficientnet_v2_weights(
    layer_names: list[str], weights_of: Callable[[str], Mapping],
    state_dict: Mapping[str, torch.Tensor],
) -> dict[str, torch.Tensor]:
    """The Keras -> port EfficientNetV2 mapping: names are the identity;
    the ImageNet head (``predictions`` / ``probs``) and preprocessing
    layers are skipped. Returns the updated copy of ``state_dict``."""
    return apply_name_identity_weights(
        layer_names, weights_of, state_dict,
        skip=("predictions", "probs", "rescaling", "normalization"))


def load_keras_efficientnet_v2_weights(
    path: str, state_dict: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a legacy-format EfficientNetV2 weights ``.h5`` (the
    downloadable ``efficientnetv2-*_notop.h5`` layout) onto the port's
    ``state_dict`` and return the updated copy; h5py only."""
    layer_names, table = read_legacy_h5(path)
    return apply_keras_efficientnet_v2_weights(
        layer_names, table.__getitem__, state_dict)

"""EfficientNet B0-B7, weight-compatible with
``keras.applications.EfficientNetB0`` ... ``B7`` (port of the JAX
package's ``models.efficientnet``).

Keras's architecture exactly: a 3x3 stride-2 stem, seven stages of MBConv
blocks (expand 1x1 -> depthwise kxk -> squeeze-excite -> project 1x1),
a 1x1 ``top_conv``, SiLU activations and BatchNorm epsilon 1e-3. B1-B7
scale the B0 table with :func:`round_filters` and :func:`round_repeats`.

- The stem and every stride-2 depthwise conv pad as Keras's
  ``correct_pad`` + VALID, which is TF's SAME geometry (``models.resnet
  .same_pad``): on an even side 0 before and 1 after for a 3x3 window, 1
  and 2 for a 5x5.
- Squeeze-excite reduces from the block's INPUT width, ``max(1,
  int(filters_in * 0.25))``, with biased 1x1 convs.
- Stochastic depth drops a residual block's branch per sample (a ``[B,
  1, 1, 1]`` mask, ``cnn.dropout``) at ``drop_connect_rate * b /
  blocks``, over the depth-scaled block count.
- The head's dropout is ``head_dropout`` (0.5) for every variant, as in
  the JAX package; Keras's ``top_dropout`` (0.2-0.5) is not used.
- Keras's preprocessing layers are not part of the model.

Each block is a submodule named as the Keras block (``block2a``) holding
modules named as the Keras layers (``block2a_dwconv``, ``block2a_se_
reduce``, ...), as the Flax parameters nest; the stem and top sit at the
root, and the Dense head is ``head``. ``load_keras_efficientnet_weights``
maps a Keras EfficientNet weights ``.h5`` (read with h5py) onto the
port's ``state_dict``.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

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

# (expand_ratio, filters_out, repeats, stride, kernel): the B0 table
_B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# (width_coefficient, depth_coefficient): the compound-scaling table
VARIANTS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}


def round_filters(filters: float, width_coefficient: float,
                  divisor: int = 8) -> int:
    """Keras's width scaling: the nearest multiple of ``divisor``, never
    below 90% of the target."""
    filters *= width_coefficient
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    return int(math.ceil(depth_coefficient * repeats))


def block_counts(variant: str) -> tuple[int, ...]:
    """Depth-scaled blocks per stage of ``variant`` (``"b0"`` ...)."""
    _, d = VARIANTS[variant]
    return tuple(round_repeats(r, d) for _, _, r, _, _ in _B0_STAGES)


class MBConv(nn.Module):
    """One Keras EfficientNet block, its modules named ``<name>_...``."""

    def __init__(self, name: str, filters_in: int, filters_out: int,
                 kernel: int, stride: int, expand_ratio: int,
                 drop_rate: float, compute_dtype: str, device=None,
                 se_ratio: float = 0.25):
        super().__init__()
        self.prefix, self.drop_rate = name, drop_rate
        self.expands = expand_ratio != 1
        self.residual = stride == 1 and filters_in == filters_out
        filters = filters_in * expand_ratio

        def add(suffix, module):
            setattr(self, f"{name}_{suffix}", module)

        def bn(suffix, features):
            add(suffix, BatchNorm(features, compute_dtype, eps=_BN_EPS,
                                  device=device))

        if self.expands:
            add("expand_conv", Conv(filters_in, filters, 1, 1, 0,
                                    compute_dtype, device))
            bn("expand_bn", filters)
        add("dwconv", Conv(filters, filters, kernel, stride, "same",
                           compute_dtype, device, groups=filters))
        bn("bn", filters)
        self.se = 0 < se_ratio <= 1
        if self.se:
            se_filters = max(1, int(filters_in * se_ratio))
            add("se_reduce", Conv(filters, se_filters, 1, 1, 0,
                                  compute_dtype, device, bias=True))
            add("se_expand", Conv(se_filters, filters, 1, 1, 0,
                                  compute_dtype, device, bias=True))
        add("project_conv", Conv(filters, filters_out, 1, 1, 0,
                                 compute_dtype, device))
        bn("project_bn", filters_out)

    def _m(self, suffix: str) -> nn.Module:
        return getattr(self, f"{self.prefix}_{suffix}")

    def forward(self, x: torch.Tensor, train: bool,
                generator: torch.Generator | None) -> torch.Tensor:
        y = x
        if self.expands:
            y = F.silu(self._m("expand_bn")(self._m("expand_conv")(y), train))
        y = F.silu(self._m("bn")(self._m("dwconv")(y), train))
        if self.se:
            se = F.silu(self._m("se_reduce")(gap(y, keepdim=True)))
            y = y * torch.sigmoid(self._m("se_expand")(se))
        y = self._m("project_bn")(self._m("project_conv")(y), train)
        if not self.residual:
            return y
        if train and self.drop_rate > 0:
            y = dropout(y, self.drop_rate, generator,
                        shape=(y.shape[0], 1, 1, 1))
        return y + x


class EfficientNet(TransferBackbone):
    """keras.applications.EfficientNetB* backbone + the transfer head.
    Input ``[B, H, W, C]`` floats; output ``[B, num_classes]`` float32
    log-probs."""

    def __init__(self, num_classes: int = 2, width_coefficient: float = 1.0,
                 depth_coefficient: float = 1.0,
                 drop_connect_rate: float = 0.2, head_dropout: float = 0.5,
                 compute_dtype: str = "bfloat16",
                 freeze_backbone: bool = False, in_channels: int = 3,
                 device=None):
        super().__init__()
        stem = round_filters(32, width_coefficient)
        self.stem_conv = Conv(in_channels, stem, 3, 2, "same", compute_dtype,
                              device)
        self.stem_bn = BatchNorm(stem, compute_dtype, eps=_BN_EPS,
                                 device=device)
        repeats = [round_repeats(r, depth_coefficient)
                   for _, _, r, _, _ in _B0_STAGES]
        blocks_total = sum(repeats)
        self.blocks: list[str] = []
        filters_in = stem
        for stage_i, ((expand, f_out, _, stride, kernel), n) in enumerate(
                zip(_B0_STAGES, repeats)):
            f_out = round_filters(f_out, width_coefficient)
            for rep in range(n):
                name = f"block{stage_i + 1}{chr(ord('a') + rep)}"
                rate = drop_connect_rate * len(self.blocks) / blocks_total
                setattr(self, name, MBConv(
                    name, filters_in, f_out, kernel,
                    stride if rep == 0 else 1, expand, rate, compute_dtype,
                    device))
                self.blocks.append(name)
                filters_in = f_out
        top = round_filters(1280, width_coefficient)
        self.top_conv = Conv(filters_in, top, 1, 1, 0, compute_dtype, device)
        self.top_bn = BatchNorm(top, compute_dtype, eps=_BN_EPS,
                                device=device)
        self._transfer_head(top, num_classes, head_dropout, compute_dtype,
                            freeze_backbone, device)

    def drop_rates(self) -> dict[str, float]:
        """Each residual block's stochastic-depth rate, where it is above
        0 (the blocks that drop in training)."""
        return {name: getattr(self, name).drop_rate for name in self.blocks
                if getattr(self, name).residual
                and getattr(self, name).drop_rate > 0}

    def features(self, x: torch.Tensor, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = F.silu(self.stem_bn(self.stem_conv(x), train))
        for name in self.blocks:
            x = getattr(self, name)(x, train, generator)
        return F.silu(self.top_bn(self.top_conv(x), train))


def _register(variant: str):
    @register_model(f"efficientnet_{variant}")
    def _build(cfg: ModelConfig, device=None) -> EfficientNet:
        w, d = VARIANTS[variant]
        return EfficientNet(cfg.num_classes, w, d,
                            compute_dtype=cfg.compute_dtype,
                            freeze_backbone=cfg.freeze_backbone,
                            in_channels=cfg.in_channels, device=device)

    return _build


for _variant in VARIANTS:
    _register(_variant)


def _module_of(layer: str) -> str:
    """A block's layers nest under the block: ``block2a_dwconv`` is
    ``block2a.block2a_dwconv``; the stem and top sit at the root."""
    if layer.startswith("block"):
        return f"{layer.split('_')[0]}.{layer}"
    return layer


def apply_keras_efficientnet_weights(
    layer_names: list[str], weights_of: Callable[[str], Mapping],
    state_dict: Mapping[str, torch.Tensor],
) -> dict[str, torch.Tensor]:
    """The Keras -> port EfficientNet mapping: layer names are module
    names, a block's nested under the block. The ImageNet head
    (``predictions``) and the preprocessing layers (``rescaling*``,
    ``normalization*``) are skipped. Returns the updated copy of
    ``state_dict``."""
    return apply_name_identity_weights(
        layer_names, weights_of, state_dict,
        skip=("predictions", "avg_pool", "top_dropout", "rescaling",
              "normalization"),
        module_of=_module_of)


def load_keras_efficientnet_weights(
    path: str, state_dict: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a Keras EfficientNet weights ``.h5`` (the legacy
    ``layer_names`` / ``weight_names`` format the downloadable
    ``efficientnetb*_notop.h5`` files use) onto the port's ``state_dict``
    and return the updated copy; h5py only."""
    layer_names, table = read_legacy_h5(path)
    return apply_keras_efficientnet_weights(layer_names, table.__getitem__,
                                            state_dict)

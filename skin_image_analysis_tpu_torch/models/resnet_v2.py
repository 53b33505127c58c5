"""ResNet-V2 (pre-activation), weight-compatible with
``keras.applications.ResNet50V2`` / ``101V2`` / ``152V2`` (port of the
JAX package's ``models.resnet_v2``).

The reference's transfer recipe lists ResNet50V2 as its first backbone
alternative. Keras's ``stack2`` order exactly:

- the stem is a 7x7 stride-2 conv with bias over a zero padding of 3 and
  no BatchNorm, then a 3x3 stride-2 max pool over a ZERO padding of 1
  (:func:`stem_pool`): a zero wins the max wherever the border's
  activations are all negative, so ``max_pool2d(padding=1)``, which pads
  -inf, is another function;
- every block opens with BatchNorm + ReLU (``_preact_bn``); the first
  block of a stack takes its 1x1 conv shortcut (``_0_conv``, with bias)
  from that pre-activation; a later strided block takes ``x[:, :, ::s,
  ::s]`` of the un-preactivated ``x``;
- only the LAST block of stacks 2-4 strides (its 3x3 ``_2_conv``), and
  conv5 never does;
- ``_1_conv`` and ``_2_conv`` have no bias, ``_3_conv`` has one;
- ``post_bn`` + ReLU before the head; BatchNorm epsilon 1.001e-5.

Module names are the Keras layer names (``conv1_conv``,
``conv4_block6_preact_bn``, ``post_bn``, ...), and the Dense head is
``head``. ``load_keras_resnet_v2_weights`` maps a Keras ResNet-V2 weights
``.h5`` (read with h5py) onto the port's ``state_dict``.
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

_BN_EPS = 1.001e-5  # Keras resnet_v2's BatchNormalization epsilon

DEPTHS = {
    "resnet50_v2": (3, 4, 6, 3),
    "resnet101_v2": (3, 4, 23, 3),
    "resnet152_v2": (3, 8, 36, 3),
}


def stem_pool(x: torch.Tensor) -> torch.Tensor:
    """Keras's stem pool of NCHW ``x``: a zero padding of 1, then a VALID
    3x3 stride-2 max pool."""
    return F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2)


class ResNetV2(TransferBackbone):
    """keras.applications.ResNet*V2 backbone + the transfer head. Input
    ``[B, H, W, C]`` floats; output ``[B, num_classes]`` float32
    log-probs."""

    def __init__(self, num_classes: int = 2,
                 depths: tuple[int, ...] = DEPTHS["resnet50_v2"],
                 head_dropout: float = 0.5, compute_dtype: str = "bfloat16",
                 freeze_backbone: bool = False, in_channels: int = 3,
                 device=None):
        super().__init__()

        def conv(name, cin, cout, kernel, stride, padding, bias):
            setattr(self, name, Conv(cin, cout, kernel, stride, padding,
                                     compute_dtype, device, bias=bias))

        def bn(name, features):
            setattr(self, name, BatchNorm(features, compute_dtype,
                                          eps=_BN_EPS, device=device))

        conv("conv1_conv", in_channels, 64, 7, 2, 3, True)
        # (block name, stride, first block of its stack)
        self.blocks: list[tuple[str, int, bool]] = []
        cin = 64
        for si, (filters, blocks) in enumerate(
                zip((64, 128, 256, 512), depths), start=2):
            for b in range(1, blocks + 1):
                name = f"conv{si}_block{b}"
                stride = 2 if (b == blocks and si != 5) else 1
                bn(f"{name}_preact_bn", cin)
                if b == 1:
                    conv(f"{name}_0_conv", cin, 4 * filters, 1, stride, 0,
                         True)
                conv(f"{name}_1_conv", cin, filters, 1, 1, 0, False)
                bn(f"{name}_1_bn", filters)
                conv(f"{name}_2_conv", filters, filters, 3, stride, 1, False)
                bn(f"{name}_2_bn", filters)
                conv(f"{name}_3_conv", filters, 4 * filters, 1, 1, 0, True)
                self.blocks.append((name, stride, b == 1))
                cin = 4 * filters
        bn("post_bn", cin)
        self._transfer_head(cin, num_classes, head_dropout, compute_dtype,
                            freeze_backbone, device)

    def _bn_relu(self, name: str, x: torch.Tensor,
                 train: bool) -> torch.Tensor:
        return F.relu(getattr(self, name)(x, train))

    def features(self, x: torch.Tensor, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = stem_pool(self.conv1_conv(x))
        for name, stride, first in self.blocks:
            preact = self._bn_relu(f"{name}_preact_bn", x, train)
            if first:
                shortcut = getattr(self, f"{name}_0_conv")(preact)
            elif stride > 1:
                shortcut = x[:, :, ::stride, ::stride]
            else:
                shortcut = x
            y = self._bn_relu(f"{name}_1_bn",
                              getattr(self, f"{name}_1_conv")(preact), train)
            y = self._bn_relu(f"{name}_2_bn",
                              getattr(self, f"{name}_2_conv")(y), train)
            x = shortcut + getattr(self, f"{name}_3_conv")(y)
        return self._bn_relu("post_bn", x, train)


def _register(name: str):
    @register_model(name)
    def _build(cfg: ModelConfig, device=None) -> ResNetV2:
        return ResNetV2(cfg.num_classes, DEPTHS[name],
                        compute_dtype=cfg.compute_dtype,
                        freeze_backbone=cfg.freeze_backbone,
                        in_channels=cfg.in_channels, device=device)

    return _build


for _name in DEPTHS:
    _register(_name)


def apply_keras_resnet_v2_weights(
    layer_names: list[str], weights_of: Callable[[str], Mapping],
    state_dict: Mapping[str, torch.Tensor],
) -> dict[str, torch.Tensor]:
    """The Keras -> port ResNet-V2 mapping: names are the identity; the
    ImageNet head (``predictions`` / ``probs``) and preprocessing layers
    are skipped. Returns the updated copy of ``state_dict``."""
    return apply_name_identity_weights(
        layer_names, weights_of, state_dict,
        skip=("predictions", "probs", "rescaling", "normalization"))


def load_keras_resnet_v2_weights(
    path: str, state_dict: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a legacy-format ResNet-V2 weights ``.h5`` (the downloadable
    ``resnet50v2_weights_tf_dim_ordering_tf_kernels_notop.h5`` layout)
    onto the port's ``state_dict`` and return the updated copy; h5py
    only."""
    layer_names, table = read_legacy_h5(path)
    return apply_keras_resnet_v2_weights(layer_names, table.__getitem__,
                                         state_dict)

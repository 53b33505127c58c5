"""Xception: the HAM-10000 transfer backbone, weight-compatible with
``keras.applications.Xception`` (port of the JAX package's
``models.xception``).

Keras's architecture exactly: VALID stem convs, entry flow 128/256/728 (two
separable convs, a 3x3 stride-2 max pool and a 1x1 stride-2 residual conv),
a middle flow of three-separable-conv residual blocks at 728, the exit
block 728/1024 and the 1536/2048 tail, BatchNorm with epsilon 1e-3; the
head is GAP -> Dropout(0.5) -> Dense -> float32 log-softmax. The input is
NHWC floats; the model permutes once and computes in NCHW at
``compute_dtype`` with float32 parameters. Module names are the Flax
model's (``block1_conv1``, ``block2_sepconv1``, ``block2_res_bn``, ...),
and the Dense head is ``head``.

The max pools pad as TF's ``"SAME"``, with -inf: on an even side 0 rows
before and 1 after, on an odd side 1 and 1 (:func:`max_pool_same`). A
``max_pool2d(3, 2, padding=1)`` gives the same shape with the windows of
an even side shifted by one. The 1x1 stride-2 residual convs pad nothing.
The BatchNorm is the ResNet family's (Flax's formula); the residual adds,
the GAP's output and the head run at ``compute_dtype``, the GAP reducing
in float32. With ``freeze_backbone`` the pooled features are detached.

The forward's three flows are the spans ``xception.entry`` (the stem and
blocks 2-4), ``xception.middle`` and ``xception.exit`` (the last two
blocks; ``utils.profiling.annotate``). ``SeparableConv.calls`` counts
separable-conv forwards since it was last set to 0: 34 a forward at the
ImageNet depth.

``load_keras_xception_weights`` maps a Keras Xception weights ``.h5``
(read with h5py) onto the port's ``state_dict``.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models.keras_io import (
    StateDictWriter,
    read_legacy_h5,
)
from skin_image_analysis_tpu_torch.models.registry import register_model
from skin_image_analysis_tpu_torch.models.resnet import (
    BatchNorm,
    Conv,
    same_pad,
)
from skin_image_analysis_tpu_torch.models.transfer import TransferBackbone
from skin_image_analysis_tpu_torch.utils.profiling import annotate

_BN_EPS = 1e-3  # Keras BatchNormalization's default


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool of NCHW ``x`` with ``"SAME"`` padding of
    -inf, as Flax's ``nn.max_pool(..., padding="SAME")``."""
    top, bottom = same_pad(x.shape[2], 3, 2)
    left, right = same_pad(x.shape[3], 3, 2)
    x = F.pad(x, (left, right, top, bottom), value=-math.inf)
    return F.max_pool2d(x, 3, 2)


class SeparableConv(nn.Module):
    """Keras SeparableConv2D: depthwise 3x3 (no bias) + pointwise 1x1.
    ``calls`` counts forwards, on every device, since it was last set to
    0."""

    calls = 0

    def __init__(self, in_channels: int, features: int, compute_dtype: str,
                 device=None):
        super().__init__()
        self.depthwise = Conv(in_channels, in_channels, 3, 1, 1,
                              compute_dtype, device, groups=in_channels)
        self.pointwise = Conv(in_channels, features, 1, 1, 0, compute_dtype,
                              device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        SeparableConv.calls += 1
        return self.pointwise(self.depthwise(x))


class Xception(TransferBackbone):
    """keras.applications.Xception backbone + the transfer head.
    ``middle_blocks=8`` is the ImageNet architecture (blocks 5-12);
    smaller values give the same topology at reduced depth. Input ``[B, H,
    W, C]`` floats; output ``[B, num_classes]`` float32 log-probs."""

    def __init__(self, num_classes: int = 2, middle_blocks: int = 8,
                 head_dropout: float = 0.5, compute_dtype: str = "bfloat16",
                 freeze_backbone: bool = False, in_channels: int = 3,
                 device=None):
        super().__init__()
        self.middle_blocks = middle_blocks

        def conv(name, bn_name, cin, cout, kernel, stride):
            setattr(self, name, Conv(cin, cout, kernel, stride, 0,
                                     compute_dtype, device))
            setattr(self, bn_name, BatchNorm(cout, compute_dtype,
                                             eps=_BN_EPS, device=device))

        def sep(name, cin, cout):
            setattr(self, name, SeparableConv(cin, cout, compute_dtype,
                                              device))
            setattr(self, f"{name}_bn", BatchNorm(cout, compute_dtype,
                                                  eps=_BN_EPS,
                                                  device=device))

        conv("block1_conv1", "block1_conv1_bn", in_channels, 32, 3, 2)
        conv("block1_conv2", "block1_conv2_bn", 32, 64, 3, 1)
        cin = 64
        for bi, feats in zip((2, 3, 4), (128, 256, 728)):
            conv(f"block{bi}_res_conv", f"block{bi}_res_bn", cin, feats, 1,
                 2)
            sep(f"block{bi}_sepconv1", cin, feats)
            sep(f"block{bi}_sepconv2", feats, feats)
            cin = feats
        for bi in range(5, 5 + middle_blocks):
            for si in (1, 2, 3):
                sep(f"block{bi}_sepconv{si}", 728, 728)
        bi = 5 + middle_blocks
        conv(f"block{bi}_res_conv", f"block{bi}_res_bn", 728, 1024, 1, 2)
        sep(f"block{bi}_sepconv1", 728, 728)
        sep(f"block{bi}_sepconv2", 728, 1024)
        sep(f"block{bi + 1}_sepconv1", 1024, 1536)
        sep(f"block{bi + 1}_sepconv2", 1536, 2048)
        self._transfer_head(2048, num_classes, head_dropout, compute_dtype,
                            freeze_backbone, device)

    def _bn(self, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
        """Module ``name`` then its BatchNorm ``<name>_bn``."""
        return getattr(self, f"{name}_bn")(getattr(self, name)(x), train)

    def _residual(self, bi: int, x: torch.Tensor,
                  train: bool) -> torch.Tensor:
        return getattr(self, f"block{bi}_res_bn")(
            getattr(self, f"block{bi}_res_conv")(x), train)

    def features(self, x: torch.Tensor, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        with annotate("xception.entry"):
            x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
            x = F.relu(self._bn("block1_conv1", x, train))
            x = F.relu(self._bn("block1_conv2", x, train))
            for bi in (2, 3, 4):
                residual = self._residual(bi, x, train)
                y = x
                for si in (1, 2):
                    if not (bi == 2 and si == 1):  # Keras: no ReLU before
                        y = F.relu(y)              # block2_sepconv1
                    y = self._bn(f"block{bi}_sepconv{si}", y, train)
                x = max_pool_same(y) + residual

        with annotate("xception.middle"):
            for bi in range(5, 5 + self.middle_blocks):
                y = x
                for si in (1, 2, 3):
                    y = self._bn(f"block{bi}_sepconv{si}", F.relu(y), train)
                x = x + y

        with annotate("xception.exit"):
            bi = 5 + self.middle_blocks
            residual = self._residual(bi, x, train)
            y = self._bn(f"block{bi}_sepconv1", F.relu(x), train)
            y = self._bn(f"block{bi}_sepconv2", F.relu(y), train)
            x = max_pool_same(y) + residual
            x = F.relu(self._bn(f"block{bi + 1}_sepconv1", x, train))
            return F.relu(self._bn(f"block{bi + 1}_sepconv2", x, train))


@register_model("xception")
def _build_xception(cfg: ModelConfig, device=None) -> Xception:
    return Xception(cfg.num_classes, compute_dtype=cfg.compute_dtype,
                    freeze_backbone=cfg.freeze_backbone,
                    in_channels=cfg.in_channels, device=device)


@register_model("xception_small")
def _build_xception_small(cfg: ModelConfig, device=None) -> Xception:
    return Xception(cfg.num_classes, middle_blocks=2,
                    compute_dtype=cfg.compute_dtype,
                    freeze_backbone=cfg.freeze_backbone,
                    in_channels=cfg.in_channels, device=device)


def apply_keras_xception_weights(
    layer_names: list[str], weights_of: Callable[[str], Mapping],
    state_dict: Mapping[str, torch.Tensor],
) -> dict[str, torch.Tensor]:
    """The Keras -> port Xception mapping, whatever the source:
    ``layer_names`` is the ordered Keras layer-name list, ``weights_of``
    maps a layer name to ``{short_weight_name: ndarray}``. Returns the
    updated copy of ``state_dict``; the head is not mapped.

    Keras stores conv kernels HWIO (here OIHW) and depthwise kernels
    ``[k, k, C, 1]`` (here ``[C, 1, k, k]``). The residual 1x1 convs and
    their BatchNorms carry Keras's automatic names (``conv2d``,
    ``conv2d_1``, ... and ``batch_normalization``, ...) in build order:
    blocks 2, 3, 4, then the exit block, whose number follows from the
    depth. A missing target raises KeyError, a shape mismatch
    ValueError."""
    writer = StateDictWriter(state_dict)

    def put_sep(port: str, layer: str) -> None:
        w = weights_of(layer)
        writer.depthwise(f"{port}.depthwise", w["depthwise_kernel"])
        writer.put(f"{port}.pointwise.weight",
                   np.transpose(w["pointwise_kernel"], (3, 2, 0, 1)))

    def numbered(prefix: str) -> list[str]:
        def rank(n):
            tail = n[len(prefix):]
            return int(tail[1:]) if tail else -1
        return sorted((n for n in layer_names
                       if n == prefix or n.startswith(prefix + "_")),
                      key=rank)

    res_convs = numbered("conv2d")
    res_bns = numbered("batch_normalization")
    sep_blocks = sorted({n.split("_")[0] for n in layer_names
                         if n.startswith("block") and "_sepconv" in n},
                        key=lambda b: int(b[5:]))
    n_blocks = int(sep_blocks[-1][5:])  # 14 at ImageNet depth
    if len(res_convs) != 4 or len(res_bns) != 4:
        raise ValueError(f"expected 4 residual convs/bns, got "
                         f"{len(res_convs)}/{len(res_bns)}")

    for name in ("block1_conv1", "block1_conv2"):
        writer.conv(name, weights_of(name))
        writer.bn(f"{name}_bn", weights_of(f"{name}_bn"))
    for res_i, bi in enumerate((2, 3, 4, n_blocks - 1)):
        writer.conv(f"block{bi}_res_conv", weights_of(res_convs[res_i]))
        writer.bn(f"block{bi}_res_bn", weights_of(res_bns[res_i]))
    for bi in range(2, n_blocks + 1):
        for si in (1, 2, 3):
            name = f"block{bi}_sepconv{si}"
            if name in layer_names:
                put_sep(name, name)
                writer.bn(f"{name}_bn", weights_of(f"{name}_bn"))
    return writer.out


def load_keras_xception_weights(
    path: str, state_dict: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a Keras Xception weights ``.h5`` (the legacy ``layer_names`` /
    ``weight_names`` format every downloadable
    ``xception_weights_tf_dim_ordering_tf_kernels*.h5`` uses) onto the
    port's ``state_dict`` and return the updated copy. Reads with h5py
    only. The ImageNet head (``predictions``) is skipped: the transfer
    recipe replaces it."""
    layer_names, table = read_legacy_h5(path)
    return apply_keras_xception_weights(layer_names, table.__getitem__,
                                        state_dict)

"""VGG-16/19, weight-compatible with ``keras.applications.VGG16`` /
``VGG19`` (port of the JAX package's ``models.vgg``).

The reference's transfer recipe lists VGG19 as a candidate backbone. Five
blocks of SAME 3x3 convs with bias and ReLU (2, 2, 3, 3, 3 convs for
VGG16; 2, 2, 4, 4, 4 for VGG19; 64 to 512 features), each closed by a 2x2
stride-2 max pool that floors an odd side; no BatchNorm. The head is the
transfer recipe's (``models.transfer``). Module names are the Keras layer
names (``block1_conv1``, ...), and the Dense head is ``head``.

``load_keras_vgg_weights`` maps a Keras VGG weights ``.h5`` (read with
h5py) onto the port's ``state_dict``.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models.keras_io import (
    StateDictWriter,
    read_legacy_h5,
)
from skin_image_analysis_tpu_torch.models.registry import register_model
from skin_image_analysis_tpu_torch.models.resnet import Conv
from skin_image_analysis_tpu_torch.models.transfer import TransferBackbone

# convs per block; the features double per block up to 512
BLOCKS = {"vgg16": (2, 2, 3, 3, 3), "vgg19": (2, 2, 4, 4, 4)}
_FEATURES = (64, 128, 256, 512, 512)


class VGG(TransferBackbone):
    """keras.applications.VGG16/19 backbone + the transfer head. Input
    ``[B, H, W, C]`` floats; output ``[B, num_classes]`` float32
    log-probs."""

    def __init__(self, num_classes: int = 2,
                 block_convs: tuple[int, ...] = BLOCKS["vgg19"],
                 head_dropout: float = 0.5, compute_dtype: str = "bfloat16",
                 freeze_backbone: bool = False, in_channels: int = 3,
                 device=None):
        super().__init__()
        self.blocks: list[list[str]] = []
        cin = in_channels
        for bi, (n, feats) in enumerate(zip(block_convs, _FEATURES), start=1):
            names = [f"block{bi}_conv{ci}" for ci in range(1, n + 1)]
            for name in names:
                setattr(self, name, Conv(cin, feats, 3, 1, 1, compute_dtype,
                                         device, bias=True))
                cin = feats
            self.blocks.append(names)
        self._transfer_head(cin, num_classes, head_dropout, compute_dtype,
                            freeze_backbone, device)

    def features(self, x: torch.Tensor, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        for names in self.blocks:
            for name in names:
                x = F.relu(getattr(self, name)(x))
            x = F.max_pool2d(x, 2, 2)
        return x


def _register(name: str):
    @register_model(name)
    def _build(cfg: ModelConfig, device=None) -> VGG:
        return VGG(cfg.num_classes, BLOCKS[name],
                   compute_dtype=cfg.compute_dtype,
                   freeze_backbone=cfg.freeze_backbone,
                   in_channels=cfg.in_channels, device=device)

    return _build


for _name in BLOCKS:
    _register(_name)


def apply_keras_vgg_weights(
    layer_names: list[str], weights_of: Callable[[str], Mapping],
    state_dict: Mapping[str, torch.Tensor],
) -> dict[str, torch.Tensor]:
    """The Keras -> port VGG mapping: every backbone layer is a biased
    3x3 conv named as the port's module; the ImageNet head (``fc1``,
    ``fc2``, ``predictions``) is skipped. Returns the updated copy of
    ``state_dict``."""
    writer = StateDictWriter(state_dict)
    for layer in layer_names:
        if layer.startswith("block") and "_conv" in layer:
            writer.conv(layer, weights_of(layer))
    return writer.out


def load_keras_vgg_weights(
    path: str, state_dict: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Map a legacy-format VGG weights ``.h5`` (the downloadable
    ``vgg1?_weights_tf_dim_ordering_tf_kernels_notop.h5`` layout) onto
    the port's ``state_dict`` and return the updated copy; h5py only."""
    layer_names, table = read_legacy_h5(path)
    return apply_keras_vgg_weights(layer_names, table.__getitem__,
                                   state_dict)

"""What the Keras-compatible transfer backbones share (``xception``,
``vgg``, ``resnet_v2``, ``mobilenet``, ``efficientnet``,
``efficientnet_v2``): Flax's default initializers and the transfer head.

The init is lecun-normal conv and Dense kernels, zero biases, BatchNorm
scale 1 and bias 0 with zero means and unit variances. The head is the
reference's transfer recipe: GAP (reducing in float32, the result at
``compute_dtype``, as ``jnp.mean`` of bf16 does), the pooled features
detached under ``freeze_backbone``, Dropout at ``head_dropout`` in
training, a Dense ``head`` and a float32 log-softmax.

A forward draws its random numbers (the EfficientNets' stochastic depth,
then the head's dropout) from its generator, or takes them from
``dropout_noise``: :meth:`TransferBackbone.draw_dropout_noise` draws the
same numbers ahead, so that a data-parallel step gives each rank its rows
of the whole batch's draws.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from skin_image_analysis_tpu_torch.models.cnn import (
    _DTYPES,
    Dense,
    DropoutNoise,
    draws_dropout,
    dropout,
)
from skin_image_analysis_tpu_torch.models.resnet import (
    BatchNorm,
    Conv,
    _lecun_normal_,
)


def gap(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Mean over the spatial axes of NCHW ``x``, reduced in float32 and
    returned at ``x``'s dtype."""
    return x.float().mean(dim=(2, 3), keepdim=keepdim).to(x.dtype)


class TransferBackbone(nn.Module):
    """Base of the Keras-compatible families; a subclass builds its
    layers, then calls :meth:`_transfer_head`, and defines
    ``features(x, train=False, generator=None)``: NHWC input -> the NCHW
    feature map that the head's GAP reads."""

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None,
                dropout_noise: Sequence[torch.Tensor] | None = None
                ) -> torch.Tensor:
        """``dropout_noise`` (rows of :meth:`draw_dropout_noise`'s draws)
        stands in for the generator's draws."""
        if dropout_noise is not None:
            generator = DropoutNoise(dropout_noise)
        return self.classify(self.features(x, train, generator), train,
                             generator)

    def draw_dropout_noise(self, b: int, generator: torch.Generator,
                           device) -> list[torch.Tensor]:
        """The uniform draws a train-mode forward over ``b`` rows makes
        from ``generator``, in its order: a ``[b, 1, 1, 1]`` mask for each
        block of ``drop_rates()`` (the EfficientNets' stochastic depth),
        then the head's ``[b, features]``, where its rate draws."""
        drops = getattr(self, "drop_rates", dict)()
        shapes = [(1, 1, 1)] * len(drops)
        if draws_dropout(self.head_dropout):
            shapes.append((self.head.weight.shape[1],))
        return [torch.rand((b, *shape), generator=generator, device=device)
                for shape in shapes]

    def _transfer_head(self, features: int, num_classes: int,
                       head_dropout: float, compute_dtype: str,
                       freeze_backbone: bool, device) -> None:
        self.head = Dense(features, num_classes, compute_dtype, "float32",
                          device)
        self.head_dropout = head_dropout
        self.freeze_backbone = freeze_backbone
        self.compute_dtype = _DTYPES[compute_dtype]

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        for m in self.modules():
            if isinstance(m, (Conv, BatchNorm)):
                m.reset_parameters(generator)
        _lecun_normal_(self.head.weight, self.head.weight.shape[1], generator)
        with torch.no_grad():
            self.head.bias.zero_()

    def classify(self, x: torch.Tensor, train: bool,
                 generator: torch.Generator | None) -> torch.Tensor:
        """NCHW features -> ``[B, num_classes]`` float32 log-probs."""
        x = gap(x)
        if self.freeze_backbone:
            x = x.detach()
        if train:
            x = dropout(x, self.head_dropout, generator)
        return F.log_softmax(self.head(x).float(), dim=-1)

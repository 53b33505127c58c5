"""Skin-cancer CNN family (port of the JAX package's ``models.cnn``).

- :class:`SkinCancerListModel`: the production model. Conv stack
  ``[32, 64, 128]`` (first kernel 7, then 3; stride 1, SAME, each + ReLU +
  2x2 max-pool), flatten, MLP ``[512, 256]`` with ReLU + dropout 0.5, a
  ``Linear(-> 2)`` head and a float32 log-softmax; Xavier-normal init.
- :class:`SkinCancerModel`: the older fixed 4-block variant.

Parameters are stored in ``param_dtype`` (float32) and cast to
``compute_dtype`` (bfloat16) for the convs and matmuls. The public input
is NHWC, as in the JAX package; the model computes in NCHW and flattens in
NCHW order (``bridge`` permutes the first dense layer's rows to and from
the JAX package's NHWC flatten order). Dropout draws from an explicit
``torch.Generator``.

``stem="s2d"`` runs block 0 over the 2x2 space-to-depth layout
(``ops.pooling.s2d_conv_block``); the model takes either raw ``[B, H, W,
in_channels]`` input, which it transforms, or input already in that
layout (``[B, H/2, W/2, 4*in_channels]``, the preprocess kernel's s2d
store). ``remat`` recomputes each conv block in the backward pass
(``torch.utils.checkpoint``). Neither changes the parameters.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models.registry import (
    get_model,
    register_model,
)
from skin_image_analysis_tpu_torch.ops.pooling import (
    phase_packed_conv_block,
    relu_max_pool_2x2,
    s2d_conv_block,
    space_to_depth,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
# stddev correction of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _s2d_stem(stem: str, fused_pool: bool, conv_features: Sequence[int],
              first_kernel: int) -> bool:
    """Whether block 0 runs as the s2d stem: it needs a conv stack, the
    fused pools and the SAME padding of an odd first kernel."""
    return (stem == "s2d" and fused_pool and len(conv_features) > 0
            and first_kernel % 2 == 1)


def _xavier_normal_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator | None) -> None:
    """Flax's ``xavier_normal``: variance 2 / (fan_in + fan_out) from a
    normal truncated at two standard deviations."""
    std = math.sqrt(2.0 / (fan_in + fan_out)) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class ConvBlock(nn.Module):
    """Conv (SAME, stride 1) + ReLU + 2x2 max-pool.

    ``pool_mode``: "phase" (pool-phase-packed stride-2 conv, the selector
    backward of ``relu_max_phase``), "selector" (stride-1 conv then
    ``relu_max_pool_2x2``), "stock" (ReLU + ``F.max_pool2d``), or "auto":
    phase while the packed channels fit 128 (``features * 4 <= 128``),
    else selector. Phase falls back to selector on odd H or W."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 compute_dtype: str, param_dtype: str, pool_mode: str,
                 device=None):
        super().__init__()
        if pool_mode not in ("auto", "phase", "selector", "stock"):
            raise ValueError(f"unknown pool_mode {pool_mode!r}")
        pdt = _DTYPES[param_dtype]
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel, kernel, dtype=pdt, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=pdt,
                                             device=device))
        self.compute_dtype = _DTYPES[compute_dtype]
        if pool_mode == "auto":
            pool_mode = "phase" if features * 4 <= 128 else "selector"
        self.pool_mode = pool_mode

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        cout, cin, k, _ = self.weight.shape
        _xavier_normal_(self.weight, cin * k * k, cout * k * k, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        """``s2d``: x is in the space-to-depth layout ``[B, 4*Cin, H/2,
        W/2]`` and the block runs as the s2d stem."""
        dt = self.compute_dtype
        w, b = self.weight.to(dt), self.bias.to(dt)
        if s2d:
            return s2d_conv_block(x, w, b)
        mode = self.pool_mode
        if mode == "phase" and (x.shape[2] % 2 or x.shape[3] % 2):
            mode = "selector"
        if mode == "phase":
            return phase_packed_conv_block(x, w, b)
        y = F.conv2d(x, w, b, padding="same")
        if mode == "selector":
            return relu_max_pool_2x2(y)
        return F.max_pool2d(F.relu(y), 2, 2)


class Dense(nn.Module):
    """``x @ weight.T + bias`` in ``compute_dtype``; weight ``[out, in]``.
    ``tp`` is the layer's tensor-parallel split
    (``parallel.tensor.TensorParallel``), None when it is whole."""

    def __init__(self, in_features: int, features: int, compute_dtype: str,
                 param_dtype: str, device=None):
        super().__init__()
        pdt = _DTYPES[param_dtype]
        self.features = features
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               dtype=pdt, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=pdt,
                                             device=device))
        self.compute_dtype = _DTYPES[compute_dtype]
        self.tp = None

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        out_f, in_f = self.weight.shape
        _xavier_normal_(self.weight, in_f, out_f, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp is not None:
            return self.tp.linear(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class DropoutNoise:
    """Uniform draws made before a forward, handed out in the order the
    forward asks for them. A model that draws its dropout through
    :func:`dropout` takes one where it takes its generator: a
    data-parallel step draws the whole batch's noise as one process
    would (the model's ``draw_dropout_noise``) and gives each rank its
    rows of it."""

    def __init__(self, noise: Sequence[torch.Tensor]):
        self._noise = iter(noise)

    def take(self, shape: Sequence[int]) -> torch.Tensor:
        u = next(self._noise, None)
        if u is None or tuple(u.shape) != tuple(shape):
            got = None if u is None else tuple(u.shape)
            raise ValueError(f"dropout noise of shape {got} where the "
                             f"forward draws {tuple(shape)}")
        return u


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | DropoutNoise | None,
            shape: tuple[int, ...] | None = None) -> torch.Tensor:
    """Inverted dropout with an explicit generator (Flax's semantics:
    keep with probability 1 - rate and scale the kept values by
    1 / (1 - rate)), or with the next draws of a :class:`DropoutNoise`.
    ``shape`` is the mask's, broadcast over ``x``: ``(B, 1, 1, 1)``
    drops whole samples (stochastic depth, Flax's
    ``broadcast_dims=(1, 2, 3)``)."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    shape = x.shape if shape is None else shape
    if isinstance(generator, DropoutNoise):
        return drop_with(x, rate, generator.take(shape))
    return drop_with(x, rate, torch.rand(shape, generator=generator,
                                         device=x.device))


def draws_dropout(rate: float) -> bool:
    """Whether :func:`dropout` at ``rate`` draws random numbers."""
    return 0.0 < rate < 1.0


def drop_with(x: torch.Tensor, rate: float, u: torch.Tensor) -> torch.Tensor:
    """:func:`dropout` at ``0 < rate < 1`` given its uniform draws ``u``."""
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class SkinCancerListModel(nn.Module):
    """List-configured CNN: the production diagnosis classifier.

    Input ``[B, H, W, in_channels]`` floats (NHWC); output ``[B,
    num_classes]`` float32 log-probabilities."""

    def __init__(
        self,
        conv_features: Sequence[int] = (32, 64, 128),
        first_kernel: int = 7,
        kernel: int = 3,
        linear_features: Sequence[int] = (512, 256),
        dropout: Sequence[float] = (0.5, 0.5),
        num_classes: int = 2,
        compute_dtype: str = "bfloat16",
        param_dtype: str = "float32",
        fused_pool: bool = True,
        pool_mode: str = "auto",
        stem: str = "auto",
        in_channels: int = 3,
        image_size: int = 224,
        remat: bool = False,
        device=None,
    ):
        super().__init__()
        mode = pool_mode if fused_pool else "stock"
        self.in_channels = in_channels
        self.remat = remat
        # the input's shape decides the rest of the s2d gate per call
        self.s2d_stem = _s2d_stem(stem, fused_pool, conv_features,
                                  first_kernel)
        blocks = []
        cin, side = in_channels, image_size
        for i, feats in enumerate(conv_features):
            k = first_kernel if i == 0 else kernel
            blocks.append(ConvBlock(cin, feats, k, compute_dtype,
                                    param_dtype, mode, device))
            cin, side = feats, side // 2
        self.conv_blocks = nn.ModuleList(blocks)
        rates = list(dropout)
        if len(rates) == 1:
            rates = rates * len(linear_features)
        self.dropout_rates = tuple(float(r) for r in rates)
        mlp = []
        width = cin * side * side
        for feats in linear_features:
            mlp.append(Dense(width, feats, compute_dtype, param_dtype,
                             device))
            width = feats
        self.mlp_blocks = nn.ModuleList(mlp)
        self.head = Dense(width, num_classes, compute_dtype, param_dtype,
                          device)
        self.compute_dtype = _DTYPES[compute_dtype]

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        for m in (*self.conv_blocks, *self.mlp_blocks, self.head):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None,
                dropout_rates: torch.Tensor | None = None,
                dropout_noise: Sequence[torch.Tensor] | None = None
                ) -> torch.Tensor:
        """``dropout_rates`` (one per MLP block, a tensor) replace the
        static rates, and ``dropout_noise`` (one uniform ``[B, width]``
        draw per MLP block) replaces the generator's draws: the traced
        per-trial rates of the JAX package's ``MlpBlock.rate_override``,
        which stacked HPO trials vary under ``torch.func.vmap``. Given
        without ``dropout_rates``, the noise (None for a block whose rate
        draws nothing, see :meth:`draw_dropout_noise`) goes with the static
        rates: how a data-parallel step drops its rows of the whole
        batch's draws."""
        return self.classify(self.features(x), len(self.conv_blocks),
                             train, generator, dropout_rates, dropout_noise)

    def features(self, x: torch.Tensor, stop: int | None = None
                 ) -> torch.Tensor:
        """NHWC input -> the NCHW (post-pool) output of the first ``stop``
        conv blocks, by default all of them."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        cin = self.in_channels
        # in_channels tells an s2d input (4*cin channels) from a raw one,
        # which a shape-only test would confuse when cin is 4
        use_s2d = self.s2d_stem and (
            x.shape[1] == 4 * cin
            or (x.shape[1] == cin and x.shape[2] % 2 == 0
                and x.shape[3] % 2 == 0))
        if use_s2d and x.shape[1] == cin:
            x = space_to_depth(x)
        return self._blocks(x, 0, stop, use_s2d)

    def _blocks(self, x: torch.Tensor, start: int, stop: int | None,
                s2d_stem: bool = False) -> torch.Tensor:
        for i in range(start, len(self.conv_blocks) if stop is None
                       else stop):
            block, s2d = self.conv_blocks[i], s2d_stem and i == 0
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, s2d, use_reentrant=False)
            else:
                x = block(x, s2d)
        return x

    def classify(self, x: torch.Tensor, start: int, train: bool = False,
                 generator: torch.Generator | None = None,
                 dropout_rates: torch.Tensor | None = None,
                 dropout_noise: Sequence[torch.Tensor] | None = None
                 ) -> torch.Tensor:
        """The rest of the model from the NCHW output of the first
        ``start`` conv blocks: the remaining blocks, the flatten, the MLP
        and the head; ``[B, num_classes]`` float32 log-probs."""
        x = self._blocks(x, start, None)
        x = x.reshape(x.shape[0], -1)
        layers = [*self.mlp_blocks, self.head]
        for j, (layer, rate) in enumerate(zip(self.mlp_blocks,
                                              self.dropout_rates)):
            x = F.relu(layer(x))
            tp = layer.tp
            if train and dropout_rates is not None:
                keep = 1.0 - dropout_rates[j]
                x = torch.where(dropout_noise[j] < keep,
                                x / keep.to(x.dtype), torch.zeros(
                                    (), dtype=x.dtype, device=x.device))
            elif train and dropout_noise is not None:
                if dropout_noise[j] is not None:
                    u = dropout_noise[j] if tp is None else tp.columns(
                        dropout_noise[j])
                    x = drop_with(x, rate, u)
            elif train:
                if tp is not None and draws_dropout(rate):
                    raise ValueError(
                        "a tensor-parallel Dense takes its dropout from "
                        "dropout_noise (the whole layer's draws)")
                x = dropout(x, rate, generator)
            following = layers[j + 1].tp
            if tp is not None and tp.kind == "col" and (
                    following is None or following.kind != "row"):
                x = tp.gather(x)
        x = self.head(x)
        return F.log_softmax(x.float(), dim=-1)

    def draw_dropout_noise(self, b: int, generator: torch.Generator,
                           device) -> list[torch.Tensor | None]:
        """The uniform draws that a train-mode forward over ``b`` rows
        makes from ``generator``, in its order: one ``[b, width]`` per MLP
        block whose rate draws, None for the others. A forward given them
        as ``dropout_noise`` (rows of them, for a shard of the batch) drops
        what the forward with ``generator`` would have dropped."""
        return [torch.rand((b, layer.features), generator=generator,
                           device=device) if draws_dropout(rate) else None
                for layer, rate in zip(self.mlp_blocks, self.dropout_rates)]


class SkinCancerModel(SkinCancerListModel):
    """Legacy fixed 4-conv-block variant: conv 32 -> 64 -> 128 -> 256, then
    MLP [512, 256]."""

    def __init__(self, num_classes: int = 2, compute_dtype: str = "bfloat16",
                 param_dtype: str = "float32", fused_pool: bool = True,
                 pool_mode: str = "auto", stem: str = "auto",
                 in_channels: int = 3, image_size: int = 224, device=None):
        super().__init__(
            conv_features=(32, 64, 128, 256), first_kernel=7, kernel=3,
            linear_features=(512, 256), dropout=(0.5, 0.5),
            num_classes=num_classes, compute_dtype=compute_dtype,
            param_dtype=param_dtype, fused_pool=fused_pool,
            pool_mode=pool_mode, stem=stem, in_channels=in_channels,
            image_size=image_size, device=device,
        )


def resolve_stem(cfg: ModelConfig) -> str:
    """``stem="auto"`` resolves to "phase", the JAX package's measured
    best block-0 lowering."""
    if cfg.stem != "auto":
        return cfg.stem
    return "phase"


def stem_wants_s2d(cfg: ModelConfig) -> bool:
    """Whether the model a config builds takes the space-to-depth input
    layout: the model's own gate, for a family that has the stem. The
    input's geometry (even sides, RGB) is checked where the layout is
    made."""
    return (cfg.name in ("skin_cancer_list", "skin_cancer")
            and _s2d_stem(resolve_stem(cfg), cfg.fused_pool,
                          cfg.conv_features, cfg.first_kernel))


def _common(cfg: ModelConfig, device) -> dict:
    return dict(
        num_classes=cfg.num_classes, compute_dtype=cfg.compute_dtype,
        param_dtype=cfg.param_dtype, fused_pool=cfg.fused_pool,
        pool_mode=cfg.pool_mode, stem=resolve_stem(cfg),
        in_channels=cfg.in_channels, image_size=cfg.image_size,
        device=device,
    )


@register_model("skin_cancer_list")
def _build_list(cfg: ModelConfig, device=None) -> SkinCancerListModel:
    return SkinCancerListModel(
        conv_features=cfg.conv_features, first_kernel=cfg.first_kernel,
        kernel=cfg.kernel, linear_features=cfg.linear_features,
        dropout=cfg.dropout, remat=cfg.remat, **_common(cfg, device))


@register_model("skin_cancer")
def _build_legacy(cfg: ModelConfig, device=None) -> SkinCancerModel:
    return SkinCancerModel(**_common(cfg, device))


def build_model(cfg: ModelConfig, device="cuda",
                generator: torch.Generator | None = None) -> nn.Module:
    """Instantiate and initialize the model a :class:`ModelConfig`
    describes, on ``device``, drawing its init from ``generator``, through
    the registry. ``remat`` applies to ``skin_cancer_list``, as in the
    JAX package."""
    model = get_model(cfg.name)(cfg, device=device)
    model.reset_parameters(generator)
    return model

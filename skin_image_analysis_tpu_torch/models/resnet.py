"""ResNet v1 family: the tone classifier's transfer backbone (port of the
JAX package's ``models.resnet``).

ResNet-18/34/50 with the JAX package's block structure (``BasicBlock`` /
``Bottleneck``, stride-2 stages, BatchNorm + ReLU, global average pool)
and its head: GAP -> Dropout(0.5) -> Dense -> float32 log-softmax. The
input is NHWC floats, as for the flagship model; the model permutes once
and computes in NCHW at ``compute_dtype`` with float32 parameters.

Every 3x3 conv pads (1, 1) symmetrically, also at stride 2; the stem is
7x7 stride 2 with (3, 3), the max pool 3x3 stride 2 with (1, 1) of -inf.
Convs have no bias and lecun-normal init; the last BatchNorm of each
block starts with a zero scale.

:class:`BatchNorm` is Flax's, not ``nn.BatchNorm2d``: in training it
normalizes with the biased batch variance ``E[x^2] - E[x]^2`` reduced in
float32, and folds that same biased variance into ``running_var`` with
Flax's momentum (``ra = 0.99 ra + 0.01 batch``); it keeps no
``num_batches_tracked``. Whether a forward trains (batch statistics,
running averages moved, dropout) is its ``train`` argument, as in the
JAX package. With ``freeze_backbone`` the pooled features are detached,
so only the head gets gradients; the BatchNorm statistics still move.

Under :func:`global_batch_stats` (a data-parallel train step on a
process mesh) the batch statistics are the global batch's, as GSPMD
computes them for the JAX package's mesh: every rank's per-channel
``[sum x, sum x^2, count]`` summed over the data axis, with the gradient
flowing through that sum (``parallel.tensor.all_reduce_sum``), and the
running averages moved by the global statistics on every rank alike.

On a CUDA tensor :class:`BatchNorm` runs the fused kernels of
``ops.kernels.batchnorm_kernel`` (the same math, with the caller's ReLU
or residual-add-and-ReLU epilogue folded in); that module's float32 chain
of PyTorch operations (``batchnorm_ref``) runs for a CPU tensor, a train
forward under :func:`global_batch_stats`, and a ``torch.export`` or
``torch.compile`` trace, so the exported graph keeps its ATen form.
A stride-1 3x3 depthwise :class:`Conv` with zero padding 1 and no bias
runs the kernels of ``ops.kernels.depthwise_kernel`` on a CUDA tensor
(the same math: the weight rounded to the activations' type, float32
accumulation), and ``F.conv2d`` on a CPU tensor and in a trace.

``load_torchvision_weights`` maps a local torchvision-named ResNet
``state_dict`` onto the port's names; it needs no torchvision.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models.cnn import (
    _DTYPES,
    _TRUNC_STD,
    Dense,
    DropoutNoise,
    draws_dropout,
    dropout,
)
from skin_image_analysis_tpu_torch.models.registry import register_model
from skin_image_analysis_tpu_torch.ops.kernels import (
    batchnorm_kernel,
    depthwise_kernel,
)
from skin_image_analysis_tpu_torch.parallel.tensor import all_reduce_sum

#: (process mesh, data axis) over whose ranks train-mode BatchNorm
#: reduces its statistics; None: this process's rows alone
_GLOBAL_STATS = contextvars.ContextVar("batchnorm_global_stats",
                                       default=None)


@contextlib.contextmanager
def global_batch_stats(mesh, data_axis: str = "data") -> Iterator[None]:
    """Within the block, every train-mode :class:`BatchNorm` normalizes
    with the statistics of the global batch, whose rows lie on the ranks
    of ``data_axis`` of the process ``mesh`` (uneven shares allowed).
    Every rank of the axis must run the same forward and backward: each
    layer's reduction is a collective."""
    token = _GLOBAL_STATS.set((mesh, data_axis))
    try:
        yield
    finally:
        _GLOBAL_STATS.reset(token)


def _global_moments(xf: torch.Tensor, mesh, data_axis: str
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, fast biased variance) per channel of the NCHW float32 rows
    on every rank of ``data_axis``."""
    count = xf.new_full((xf.shape[1],), float(xf.numel() // xf.shape[1]))
    sums = all_reduce_sum(torch.stack([xf.sum(dim=(0, 2, 3)),
                                       (xf * xf).sum(dim=(0, 2, 3)), count]),
                          mesh, data_axis)
    mean = sums[0] / sums[2]
    return mean, torch.clamp_min(sums[1] / sums[2] - mean * mean, 0.0)


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator | None) -> None:
    """Flax's ``lecun_normal``: variance 1 / fan_in from a normal truncated
    at two standard deviations, drawn by the inverse CDF as
    ``jax.random.truncated_normal`` draws it."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    lo, hi = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))
    with torch.no_grad():
        w.uniform_(lo, hi, generator=generator).erfinv_().mul_(
            std * math.sqrt(2.0))


def same_pad(n: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF ``"SAME"`` padding (before, after) of a ``kernel`` window at
    ``stride`` over a side of ``n``: on an even side a 3x3 stride-2
    window pads 0 before and 1 after. For a stride-2 window this is also
    Keras's ``correct_pad`` followed by a VALID conv."""
    total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Conv with an optional bias; weight ``[O, I / groups, k, k]``
    (``groups=in_channels`` is a depthwise conv). ``padding`` is a
    symmetric zero padding, or ``"same"``: TF's, from the input's sides
    (:func:`same_pad`). A depthwise 3x3 conv at stride 1 with a zero
    padding of 1 (``1``, or ``"same"`` at stride 1) and no bias runs the
    depthwise kernels on the card (:meth:`depthwise3x3`)."""

    def __init__(self, in_channels: int, features: int, kernel: int,
                 stride: int, padding: int | str, compute_dtype: str,
                 device=None, groups: int = 1, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            features, in_channels // groups, kernel, kernel,
            dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.empty(
            features, dtype=torch.float32, device=device)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups
        self.compute_dtype = _DTYPES[compute_dtype]

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        _, cin, k, _ = self.weight.shape
        _lecun_normal_(self.weight, cin * k * k, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        padding = self.padding
        if padding == "same":
            k, s = self.weight.shape[2], self.stride
            (top, bottom), (left, right) = (same_pad(x.shape[2], k, s),
                                            same_pad(x.shape[3], k, s))
            padding = (top, left)
            if (top, left) != (bottom, right):
                x = F.pad(x, (left, right, top, bottom))
                padding = 0
        if self.depthwise3x3(x, padding):
            return depthwise_kernel.depthwise3x3(x.contiguous(), self.weight)
        dt = self.compute_dtype
        return F.conv2d(x, self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt),
                        stride=self.stride, padding=padding,
                        groups=self.groups)

    def depthwise3x3(self, x: torch.Tensor, padding) -> bool:
        """Whether the forward of ``x`` at the resolved ``padding`` runs
        the depthwise kernels: ``groups`` equal to the input and output
        channels, a 3x3 weight, stride 1, a zero padding of 1 on every
        side, no bias, x at the compute dtype, on the card
        (:func:`_on_card`)."""
        c = self.weight.shape[0]
        return (self.groups == c == x.shape[1]
                and tuple(self.weight.shape[1:]) == (1, 3, 3)
                and self.stride == 1 and padding in (1, (1, 1))
                and self.bias is None and x.dtype == self.compute_dtype
                and _on_card(x))


def _on_card(x: torch.Tensor) -> bool:
    """Whether a layer may run the port's kernels on ``x``: a CUDA tensor,
    while neither ``torch.export`` nor ``torch.compile`` traces."""
    return (x.device.type == "cuda"
            and not torch.compiler.is_exporting()
            and not torch.compiler.is_compiling())


def _fused(x: torch.Tensor, train: bool) -> bool:
    """Whether :class:`BatchNorm` runs the fused kernels: on the card
    (:func:`_on_card`), but not in a train forward whose statistics are
    the mesh's."""
    return (_on_card(x)
            and not (train and _GLOBAL_STATS.get() is not None))


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm`` over NCHW (momentum 0.99, epsilon 1e-5,
    fast biased variance, float32 statistics); output at
    ``compute_dtype``. In training its statistics are the global batch's
    under :func:`global_batch_stats`, else this call's rows'. The
    epilogue: ``relu(out)`` with ``relu``; ``relu(out + residual)`` (the
    add at ``compute_dtype``) with ``relu`` and ``residual``."""

    def __init__(self, features: int, compute_dtype: str,
                 zero_scale: bool = False, momentum: float = 0.99,
                 eps: float = 1e-5, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.empty(features, **f32))
        self.bias = nn.Parameter(torch.empty(features, **f32))
        self.register_buffer("running_mean", torch.zeros(features, **f32))
        self.register_buffer("running_var", torch.ones(features, **f32))
        self.zero_scale = zero_scale
        self.momentum, self.eps = momentum, eps
        self.compute_dtype = _DTYPES[compute_dtype]

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_scale else 1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool, relu: bool = False,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if not _fused(x, train):
            over = _GLOBAL_STATS.get() if train else None
            return batchnorm_kernel.batchnorm_ref(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, train=train, momentum=self.momentum,
                eps=self.eps, dtype=self.compute_dtype, relu=relu,
                residual=residual,
                moments=None if over is None
                else lambda xf: _global_moments(xf, *over))[0]
        if x.dtype != self.compute_dtype:
            raise ValueError(f"x is {x.dtype}, the layer computes in "
                             f"{self.compute_dtype}")
        # the kernels take NCHW: an NHWC input's channels-last stem
        # activation is made NCHW here, at its first BatchNorm, and every
        # layer after it is NCHW (a no-op on the train step's)
        return batchnorm_kernel.batchnorm(
            x.contiguous(), self.weight, self.bias, self.running_mean,
            self.running_var, train=train, momentum=self.momentum,
            eps=self.eps, relu=relu,
            residual=None if residual is None else residual.contiguous())


class _Block(nn.Module):
    """A residual block: ``convs[i]`` / ``bns[i]`` in order (Flax's
    ``Conv_i`` / ``BatchNorm_i``), ReLU between them, the projection
    shortcut ``downsample_conv`` / ``downsample_bn`` where the shape
    changes. Each BatchNorm takes its ReLU as its epilogue, and the last
    one the residual add and the ReLU after it."""

    def _build(self, in_channels: int, out_channels: int, stride: int,
               convs: Sequence[tuple[int, int, int, int]],
               compute_dtype: str, device) -> None:
        for i, (cin, cout, k, s) in enumerate(convs):
            setattr(self, f"conv{i}", Conv(cin, cout, k, s, k // 2,
                                           compute_dtype, device))
            setattr(self, f"bn{i}", BatchNorm(
                cout, compute_dtype, zero_scale=i == len(convs) - 1,
                device=device))
        self.n_convs = len(convs)
        self.downsample_conv = self.downsample_bn = None
        if in_channels != out_channels or stride != 1:
            self.downsample_conv = Conv(in_channels, out_channels, 1, stride,
                                        0, compute_dtype, device)
            self.downsample_bn = BatchNorm(out_channels, compute_dtype,
                                           device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), train)
        y = x
        for i in range(self.n_convs):
            last = i == self.n_convs - 1
            y = getattr(self, f"bn{i}")(
                getattr(self, f"conv{i}")(y), train, relu=True,
                residual=residual if last else None)
        return y


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_channels: int, features: int, stride: int,
                 compute_dtype: str, device=None):
        super().__init__()
        self._build(in_channels, features, stride,
                    [(in_channels, features, 3, stride),
                     (features, features, 3, 1)], compute_dtype, device)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, in_channels: int, features: int, stride: int,
                 compute_dtype: str, device=None):
        super().__init__()
        self._build(in_channels, features * 4, stride,
                    [(in_channels, features, 1, 1),
                     (features, features, 3, stride),
                     (features, features * 4, 1, 1)], compute_dtype, device)


class ResNet(nn.Module):
    """ResNet with the tone classifier's head. Input ``[B, H, W, C]``
    floats; output ``[B, num_classes]`` float32 log-probabilities."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block: str = "basic", num_classes: int = 2,
                 head_dropout: float = 0.5, compute_dtype: str = "bfloat16",
                 freeze_backbone: bool = False, in_channels: int = 3,
                 device=None):
        super().__init__()
        self.stem_conv = Conv(in_channels, 64, 7, 2, 3, compute_dtype, device)
        self.stem_bn = BatchNorm(64, compute_dtype, device=device)
        block_cls = BasicBlock if block == "basic" else Bottleneck
        blocks, cin = [], 64
        for stage, n_blocks in enumerate(stage_sizes):
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(block_cls(cin, 64 * 2**stage, stride,
                                        compute_dtype, device))
                cin = 64 * 2**stage * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(cin, num_classes, compute_dtype, "float32", device)
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

    def forward(self, x: torch.Tensor, *, train: bool = False,
                generator: torch.Generator | None = None,
                dropout_noise: Sequence[torch.Tensor] | None = None
                ) -> torch.Tensor:
        """``dropout_noise`` (rows of :meth:`draw_dropout_noise`'s draws)
        stands in for the generator's draws."""
        if dropout_noise is not None:
            generator = DropoutNoise(dropout_noise)
        return self.classify(self.features(x, train), train, generator)

    def draw_dropout_noise(self, b: int, generator: torch.Generator,
                           device) -> list[torch.Tensor]:
        """The uniform draws a train-mode forward over ``b`` rows makes
        from ``generator``, in its order: the head's ``[b, features]``
        dropout noise, where its rate draws."""
        if not draws_dropout(self.head_dropout):
            return []
        return [torch.rand((b, self.head.weight.shape[1]),
                           generator=generator, device=device)]

    def features(self, x: torch.Tensor, train: bool = False,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """NHWC input -> the last block's NCHW output, which the head's
        GAP reads."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = self.stem_bn(self.stem_conv(x), train, relu=True)
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in self.blocks:
            x = block(x, train)
        return x

    def classify(self, x: torch.Tensor, train: bool,
                 generator: torch.Generator | None) -> torch.Tensor:
        """NCHW features -> ``[B, num_classes]`` float32 log-probs."""
        x = x.mean(dim=(2, 3))
        if self.freeze_backbone:
            x = x.detach()
        if train:
            x = dropout(x, self.head_dropout, generator)
        return F.log_softmax(self.head(x).float(), dim=-1)


_STAGES = {"resnet18": ((2, 2, 2, 2), "basic"),
           "resnet34": ((3, 4, 6, 3), "basic"),
           "resnet50": ((3, 4, 6, 3), "bottleneck")}


def _builder(name: str):
    """The public builder ``name`` (JAX's signature plus ``in_channels``
    and ``device``), registered under the same name."""
    stages, block = _STAGES[name]

    def build(num_classes: int = 2, compute_dtype: str = "bfloat16",
              freeze_backbone: bool = False, in_channels: int = 3,
              device=None) -> ResNet:
        return ResNet(stages, block, num_classes,
                      compute_dtype=compute_dtype,
                      freeze_backbone=freeze_backbone,
                      in_channels=in_channels, device=device)

    build.__name__ = build.__qualname__ = name

    @register_model(name)
    def _build(cfg: ModelConfig, device=None) -> ResNet:
        return build(cfg.num_classes, cfg.compute_dtype,
                     cfg.freeze_backbone, cfg.in_channels, device)

    return build


resnet18 = _builder("resnet18")
resnet34 = _builder("resnet34")
resnet50 = _builder("resnet50")


def load_torchvision_weights(path: str,
                             state_dict: dict[str, torch.Tensor]
                             ) -> dict[str, torch.Tensor]:
    """Map a local torchvision ResNet ``state_dict`` file onto the port's
    ``state_dict`` (parameters and BatchNorm buffers) and return the
    updated copy. The head (``fc.*``) is skipped: the transfer recipe
    re-initializes it. A shape or block-count mismatch raises
    ValueError."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    out = dict(state_dict)

    def put(key: str, value: torch.Tensor) -> None:
        if key in state_dict:
            expect = tuple(state_dict[key].shape)
            if tuple(value.shape) != expect:
                raise ValueError(f"{key}: {tuple(value.shape)} vs {expect}")
            out[key] = value.to(state_dict[key].dtype).clone()

    def put_bn(port: str, tv: str) -> None:
        for mine, theirs in (("weight", "weight"), ("bias", "bias"),
                             ("running_mean", "running_mean"),
                             ("running_var", "running_var")):
            put(f"{port}.{mine}", sd[f"{tv}.{theirs}"])

    put("stem_conv.weight", sd["conv1.weight"])
    put_bn("stem_bn", "bn1")
    n_blocks = len({k.split(".")[1] for k in state_dict
                    if k.startswith("blocks.")})
    layer_sizes: dict[int, int] = {}
    for k in sd:
        if k.startswith("layer"):
            layer = int(k[5])
            layer_sizes[layer] = max(layer_sizes.get(layer, 0),
                                     int(k.split(".")[1]) + 1)
    tv_blocks = [f"layer{layer}.{i}" for layer in sorted(layer_sizes)
                 for i in range(layer_sizes[layer])]
    if len(tv_blocks) != n_blocks:
        raise ValueError(f"block count mismatch: torchvision "
                         f"{len(tv_blocks)} vs the port's {n_blocks}")
    for n, tv in enumerate(tv_blocks):
        convs = sorted({int(k.split(".")[2][4:]) for k in state_dict
                        if k.startswith(f"blocks.{n}.conv")})
        for j in convs:
            put(f"blocks.{n}.conv{j}.weight", sd[f"{tv}.conv{j + 1}.weight"])
            put_bn(f"blocks.{n}.bn{j}", f"{tv}.bn{j + 1}")
        if f"{tv}.downsample.0.weight" in sd:
            put(f"blocks.{n}.downsample_conv.weight",
                sd[f"{tv}.downsample.0.weight"])
            put_bn(f"blocks.{n}.downsample_bn", f"{tv}.downsample.1")
    return out

"""Depthwise 3x3 convolution: the CUDA kernels' wrappers, their plain
PyTorch versions, the launch plan and the autograd Function around them.

The kernels (``csrc/depthwise_kernel.cu``) replace no Pallas kernel: the
JAX package's ``models/xception.py`` ``SeparableConv`` runs its depthwise
conv as a Flax ``nn.Conv`` with ``feature_group_count``, which XLA lowers.
They replace, on the card, ATen's NCHW ``conv_depthwise2d`` kernels
(forward, input gradient, weight gradient), which held 45% of the Xception
cell's device time at under a tenth of their bound. They compute a 3x3,
stride-1, zero-padding-1 depthwise convolution: stride-1 3x3 depthwise
``models.resnet.Conv`` layers (Xception's 34, MobileNetV2's and the
EfficientNets' stride-1 3x3 ones) run them on a CUDA tensor.

The math is the one ``Conv`` ran on the card before: activations in and
out at their type, the float32 ``[C, 1, 3, 3]`` weight rounded to that type
before use, float32 accumulation, each output rounded once. The input
gradient is the correlation of dy with the rotated rounded weight, rounded
once; the weight gradient the float32 sum of ``x[h + ky - 1, w + kx - 1] *
dy[h, w]``, written in float32 (ATen rounds it to the activations' type on
its way back to the parameter).

The bound is device-memory bytes (18 flops an output against 4 bytes in
bf16), 3.35 TB/s on an H100. The design moves each tensor once: a block
owns one channel and walks bands of rows (large planes) or several whole
planes a stage (small ones), each band with its halo one contiguous span of
an NCHW plane copied to shared memory with 16-byte ``cp.async`` over its
aligned chunks, double-buffered; a thread computes 8 bf16 outputs and
stores them as one vector. The backward reads x and dy once and writes dx
and each block's float32 dW partial sums in the same pass; a finalize
kernel adds the partial sums in a fixed order, so dW repeats bit for bit.

:func:`depthwise_forward` is one launch and :func:`depthwise_backward` two
(the pass and the finalize); each counts its calls in ``.launches``.
:func:`depthwise3x3` is the differentiable entry. They take CUDA tensors
alone: x NCHW-contiguous, float32, bfloat16 or float16, 16-byte aligned;
the weight float32 ``[C, 1, 3, 3]``; an input they do not take raises.
:func:`depthwise3x3_ref` and :func:`depthwise3x3_backward_ref` are the
plain versions; :func:`depthwise_plan` the launch plan.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

THREADS = 256
# Shared memory a stage holds for each tensor the kernel reads (a band of
# rows of a large plane, or several whole small planes): the forward's
# stage of x, the backward's of x and dy each. Double-buffered, they leave
# room for 4 forward or 3 backward blocks an SM, the most their registers
# allow.
STAGE_BYTES = {1: 24576, 2: 16384}
# A stage's fixed cost (its barriers, unit table and copies issued), in
# passes of THREADS threads over its output groups.
STAGE_OVERHEAD = 1
# Units a stage, at most (the kernels' unit table).
MAX_GROUP = 32
# The grid a plan aims for: about four waves of the blocks an H100 holds
# at once (132 SMs, 3-4 blocks each), so a ragged last wave costs little.
TARGET_BLOCKS = 2048
# Stages a block walks, at least where the channel has them, so that one
# stage's copy overlaps the previous one's arithmetic.
MIN_STAGES = 2
# The kernels' shared memory (the unit tables: 3 x MAX_GROUP units of 48
# bytes) and the card's limit for one block.
TABLE_BYTES = 3 * MAX_GROUP * 48
MAX_SHARED = 227 * 1024

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class DepthwisePlan(NamedTuple):
    """How the kernels walk an NCHW ``[N, C, H, W]`` activation (see
    :func:`depthwise_plan`). A unit is a band of ``rows`` output rows of
    one plane (``bands`` a plane, the last possibly shorter); the units of
    a channel are taken plane by plane, band by band."""

    rows: int     # output rows a band
    bands: int    # bands a plane
    group: int    # units a stage
    stages: int   # stages a block walks
    chunks: int   # blocks a channel (the grid's y; the grid's x is C)
    slot: int     # shared-memory elements a unit's slot
    lmax: int     # 16-byte chunks a unit copies, at most
    kmax: int     # output groups (16-byte vectors) a unit, at most

    def args(self) -> list[int]:
        return list(self)


def depthwise_plan(n: int, c: int, h: int, w: int, elem_bytes: int = 2,
                   sources: int = 1) -> DepthwisePlan:
    """The launch plan of an NCHW ``[n, c, h, w]`` activation of
    ``elem_bytes`` elements for the forward (``sources`` 1: it stages x) or
    the backward (2: x and dy), from the shape alone.

    A unit's slot holds its band with one halo row above and below and the
    margins of the 16-byte reads around it. A whole plane is one unit where
    its slot fits the stage (:data:`STAGE_BYTES`; Xception's 74², 37², 19²,
    10²), and a stage then holds up to :data:`MAX_GROUP` whole planes, as
    many as fit; a larger plane (147²) is cut into bands of rows that fit.
    Of the stage sizes that fit (planes a stage, or rows a band), the plan
    takes the one of least :func:`stage_cost` an output group, the larger
    on a tie. Chunks of stages then make the grid about
    :data:`TARGET_BLOCKS` blocks (C of them a chunk), each block walking at
    least :data:`MIN_STAGES` stages where the channel has that many.
    """
    if min(n, c, h, w) < 1:
        raise ValueError(f"shape {(n, c, h, w)} must be positive")
    if elem_bytes not in (2, 4) or sources not in STAGE_BYTES:
        raise ValueError(f"elem_bytes {elem_bytes} must be 2 or 4 and "
                         f"sources {sources} 1 or 2")
    vec = 16 // elem_bytes
    budget = STAGE_BYTES[sources] // elem_bytes

    def slot(rows):
        return -(-((rows + 2) * w + 6 * vec) // vec) * vec

    def kmax(rows):
        return (rows * w + 3 * vec - 3) // vec

    def per_group(stages):
        return sum(map(stage_cost, stages)) / sum(stages)

    if slot(h) <= budget:
        rows = h
        fit = max(1, min(MAX_GROUP, budget // slot(h), n))
        group = min(range(1, fit + 1),
                    key=lambda g: (per_group([g * kmax(h)]), -g))
    else:
        fit = max(1, (budget - 6 * vec) // w - 2)
        group = 1

        def bands_of(r):
            return [kmax(r)] * (h // r) + [kmax(h % r)] * (h % r > 0)

        rows = min(range(1, fit + 1),
                   key=lambda r: (per_group(bands_of(r)), -r))
    bands = -(-h // rows)
    units = n * bands
    per_channel = -(-units // group)
    chunks = max(1, min(-(-TARGET_BLOCKS // c), per_channel // MIN_STAGES))
    stages = -(-per_channel // chunks)
    chunks = -(-per_channel // stages)
    return DepthwisePlan(rows, bands, group, stages, chunks, slot(rows),
                         ((rows + 2) * w + 3 * vec - 3) // vec, kmax(rows))


def stage_cost(groups: int) -> int:
    """A stage of ``groups`` output groups, in passes of :data:`THREADS`
    threads: ceil(groups / THREADS) passes and :data:`STAGE_OVERHEAD`."""
    return STAGE_OVERHEAD + -(-groups // THREADS)


def shared_bytes(plan: DepthwisePlan, elem_bytes: int, sources: int) -> int:
    """Dynamic shared memory of the forward (``sources`` 1) or the
    backward (2, which also holds its block's reduction)."""
    bufs = 2 * sources * plan.group * plan.slot * elem_bytes
    if sources == 2:
        bufs = max(bufs, THREADS * 9 * 4)
    return TABLE_BYTES + bufs


def depthwise_bytes(n: int, c: int, h: int, w: int, elem_bytes: int = 2, *,
                    form: str = "forward") -> int:
    """Device-memory bytes of one call, each tensor read or written once
    (the weights left out): the forward reads x and writes y; the backward
    reads x and dy and writes dx."""
    if form not in ("forward", "backward"):
        raise ValueError(f"form {form!r} must be forward or backward")
    t = n * c * h * w * elem_bytes
    return 2 * t if form == "forward" else 3 * t


# -- the plain versions ------------------------------------------------------


def _rounded(weight: torch.Tensor, x: torch.Tensor) -> tuple:
    """(accumulation type, the weight rounded to x's type in it)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return acc, weight.to(x.dtype).to(acc)


def depthwise3x3_ref(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The plain forward: the weight rounded to x's type, the correlation
    in float32 (float64 for float64 x), rounded once to x's type."""
    acc, w = _rounded(weight, x)
    return F.conv2d(x.to(acc), w, padding=1,
                    groups=x.shape[1]).to(x.dtype)


def depthwise3x3_backward_ref(dy: torch.Tensor, x: torch.Tensor,
                              weight: torch.Tensor):
    """The plain backward: ``(dx, dw)``, dx the correlation of dy with the
    rotated rounded weight rounded once to x's type, dw the products' sum
    in float32 (float64 for float64 x) at the weight's type."""
    acc, w = _rounded(weight, x)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.to(acc), x.to(acc), w, None, [1, 1], [1, 1], [1, 1], False,
        [0, 0], x.shape[1], [True, True, False])
    return dx.to(x.dtype), dw.to(torch.promote_types(weight.dtype, acc))


# -- the kernels -------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from skin_image_analysis_tpu_torch.ops.kernels import build

    lib = build.load("depthwise_kernel")
    if lib.sia_depthwise_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sia_depthwise_forward.argtypes = [p] * 3 + [i] * 5 + [p, p]
        lib.sia_depthwise_backward.argtypes = [p] * 6 + [i] * 5 + [p, p]
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device, aligned: bool = True) -> None:
    """Device, type, shape and contiguity; an activation (``aligned``)
    also on a 16-byte boundary, for the kernels' vector accesses."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


class _Geometry(NamedTuple):
    shape: tuple
    plan: DepthwisePlan

    def args(self):
        return (*self.shape, (ctypes.c_int * 8)(*self.plan.args()))


def _geometry(x: torch.Tensor, weight: torch.Tensor,
              sources: int) -> _Geometry:
    """Shape and plan of a CUDA activation and weight the kernels take, for
    the forward (``sources`` 1) or the backward (2)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32, bfloat16 or float16, got "
                         f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    _check("x", x, x.dtype, tuple(x.shape), x.device)
    n, c, h, w = x.shape
    _check("weight", weight, torch.float32, (c, 1, 3, 3), x.device,
           aligned=False)
    plan = depthwise_plan(n, c, h, w, x.element_size(), sources)
    if shared_bytes(plan, x.element_size(), sources) > MAX_SHARED:
        raise ValueError(f"rows of {w} elements exceed the kernels' shared "
                         f"memory")
    return _Geometry((n, c, h, w), plan)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"depthwise {what} kernel launch failed: CUDA "
                           f"error {err}")


def depthwise_forward(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """y like x: the 3x3 correlation of each channel with its rounded
    weight, zero padding 1. Not differentiable (:func:`depthwise3x3`
    is)."""
    geo = _geometry(x, weight, 1)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().sia_depthwise_forward(
            x.data_ptr(), weight.data_ptr(), y.data_ptr(),
            _DTYPE_CODE[x.dtype], *geo.args(), _stream(x.device))
    _raise_on(err, "forward")
    depthwise_forward.launches += 1
    return y


def depthwise_backward(dy: torch.Tensor, x: torch.Tensor,
                       weight: torch.Tensor):
    """``(dx, dw)``: dx like x, dw float32 like the weight."""
    geo = _geometry(x, weight, 2)
    _check("dy", dy, x.dtype, tuple(x.shape), x.device)
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    partial = torch.empty((geo.plan.chunks, geo.shape[1], 9),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().sia_depthwise_backward(
            x.data_ptr(), dy.data_ptr(), weight.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), partial.data_ptr(), _DTYPE_CODE[x.dtype],
            *geo.args(),
            _stream(x.device))
    _raise_on(err, "backward")
    depthwise_backward.launches += 1
    return dx, dw


# Calls that launched the kernels since the count was last set to 0 (a
# forward is one launch, a backward two).
depthwise_forward.launches = 0
depthwise_backward.launches = 0


class _Depthwise3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return depthwise_forward(x, weight)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = depthwise_backward(dy.contiguous(), x, weight)
        need = ctx.needs_input_grad
        return dx if need[0] else None, dw if need[1] else None


def depthwise3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The depthwise 3x3 convolution on the card (stride 1, zero padding
    1), differentiable in x and the float32 weight."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _Depthwise3x3.apply(x, weight)
    return depthwise_forward(x, weight)

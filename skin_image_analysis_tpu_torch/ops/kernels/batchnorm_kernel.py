"""Fused BatchNorm: the CUDA kernels' wrappers, their plain PyTorch
versions and the autograd Function around them.

The kernels (``csrc/batchnorm_kernel.cu``) replace no Pallas kernel: the
JAX package's Flax BatchNorm ran as XLA fusions. They replace, on the
card, the port's float32 chain of ``models.resnet.BatchNorm`` (18 kernels
a train-mode layer, and autograd's walk back over saved float32 copies)
and the ReLU and residual add after it, which were the ResNet cells'
largest device cost. The math is the chain's: float32 statistics, the
fast biased variance ``clamp_min(E[x^2] - E[x]^2, 0)``, ``rsqrt(var +
eps)``, the running averages moved by the batch's mean and clamped
variance, ``y = (x - mean) * (rstd * gamma) + beta`` in float32 rounded
once to the activations' type, and the epilogue the caller asks for:

- ``relu``: ``relu(y)``;
- ``residual`` (with ``relu``): ``relu(round(round(y) + residual))``, the
  chain's bf16 add.

:func:`batchnorm_train_forward` is three launches (statistics into
per-chunk partial sums, a finalize over the channels, the apply),
:func:`batchnorm_eval_forward` one (the apply with the running
statistics), :func:`batchnorm_backward` three (a reduction of ``sum g``
and ``sum g * xhat``, a finalize, the apply that writes dx and the
residual's gradient). :func:`batchnorm` is the differentiable entry; the
backward saves x and per-channel vectors (and, behind the residual, the
output), and recomputes xhat and the ReLU mask.

The wrappers launch the kernels and take CUDA tensors alone; an input
that the kernels do not take raises. Layout NCHW ``[N, C, H, W]``,
contiguous, float32, bfloat16 or float16, 16-byte aligned; the parameters
and running statistics float32 ``[C]``. :func:`batchnorm_ref` is the plain
forward, and the path that ``models.resnet.BatchNorm`` runs wherever the
kernels do not; :func:`batchnorm_backward_ref` the plain backward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

# A block's threads, and its warps: one channel each.
THREADS = 256
WARPS = THREADS // 32
# The grid a plan aims for: one wave of 8 blocks on each of an H100's 132
# SMs (1,056), rounded down to a power of two.
TARGET_BLOCKS = 1024
# A plane is cut into segments only while a half segment keeps this many
# elements (a small batch's large planes).
SEG_MIN = 1024

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class PlanePlan(NamedTuple):
    """How the kernels walk an NCHW-contiguous ``[N, C, HW]``: a warp a
    channel, :data:`WARPS` channels a block (see :func:`bn_plan`)."""

    segments: int         # segments a plane is cut into
    seg_len: int          # elements a segment (the last may be shorter)
    rows: int             # N * segments: the rows of a channel
    rows_per_chunk: int   # rows a block walks
    chunks: int           # blocks along the rows (the grid's y)
    channel_blocks: int   # blocks along the channels (the grid's x)

    @property
    def blocks(self) -> int:
        return self.channel_blocks * self.chunks

    def args(self) -> list[int]:
        return [self.segments, self.seg_len, self.rows_per_chunk,
                self.chunks]


def bn_plan(n: int, c: int, hw: int, elem_bytes: int = 2) -> PlanePlan:
    """The launch plan of an NCHW ``[n, c, hw]`` activation of
    ``elem_bytes`` elements, from its shape alone.

    A block owns :data:`WARPS` channels, a warp each, and walks a chunk of
    rows of them; a row is a plane of ``hw`` contiguous elements, or a
    segment of one: planes are halved (into multiples of the 16-byte
    vector) while the grid of one row a chunk falls short of
    :data:`TARGET_BLOCKS` and a half keeps :data:`SEG_MIN` elements. Rows a
    chunk then make the grid about :data:`TARGET_BLOCKS` blocks (every
    ResNet-50 layer at B=256 gets exactly 1,024); a grid that is short of
    it keeps one row a chunk.
    """
    if min(n, c, hw) < 1:
        raise ValueError(f"shape {(n, c, hw)} must be positive")
    if elem_bytes not in (2, 4):
        raise ValueError(f"elem_bytes {elem_bytes} must be 2 or 4")
    vec = 16 // elem_bytes
    cb = -(-c // WARPS)

    def seg_len(s):
        return hw if s == 1 else -(-(-(-hw // s)) // vec) * vec

    s = 1
    while cb * n * s < TARGET_BLOCKS and seg_len(2 * s) >= SEG_MIN:
        s *= 2
    length = seg_len(s)
    s = -(-hw // length)
    rows = n * s
    rpc = max(1, cb * rows // TARGET_BLOCKS)
    return PlanePlan(s, length, rows, rpc, -(-rows // rpc), cb)


# -- the plain versions ------------------------------------------------------


def batchnorm_ref(x, weight, bias, running_mean, running_var, *,
                  train: bool, momentum: float, eps: float, dtype=None,
                  relu: bool = False, residual=None, moments=None):
    """The plain forward: the float32 chain of PyTorch operations that
    ``models.resnet.BatchNorm`` runs wherever the kernels do not (a CPU
    tensor, a mesh's statistics, a trace), and that the kernels are held
    to. ``(y, mean, rstd, raw)``: y at ``dtype`` (x's by default), the
    statistics that normalized (the running ones in eval), and the
    variance before its clamp where this call's rows gave it (else None;
    its gradient is 0 where ``raw < 0``). In training the running averages
    move in place, by ``moments(xf)`` (the mean and variance of a mesh's
    rows) where given. float64 activations compute in float64 (the
    backward's check on the CPU), every other type in float32."""
    xf = x.double() if x.dtype == torch.float64 else x.float()
    raw = None
    if train:
        if moments is None:
            mean = xf.mean(dim=(0, 2, 3))
            raw = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
            var = torch.clamp_min(raw, 0.0)
        else:
            mean, var = moments(xf)
        with torch.no_grad():
            running_mean.mul_(momentum).add_(mean.detach(),
                                             alpha=1 - momentum)
            running_var.mul_(momentum).add_(var.detach(), alpha=1 - momentum)
    else:
        mean, var = running_mean, running_var
    rstd = torch.rsqrt(var + eps)
    y = batchnorm_apply_ref(xf, weight, bias, mean, rstd,
                            x.dtype if dtype is None else dtype, relu,
                            residual)
    return y, mean, rstd, raw


def batchnorm_apply_ref(xf, weight, bias, mean, rstd, dtype,
                        relu: bool = False, residual=None) -> torch.Tensor:
    """The chain's apply, given the statistics: ``(xf - mean) * (rstd *
    weight) + bias`` in ``xf``'s type (x made float32), rounded once to
    ``dtype``, then the epilogue."""
    mul = rstd * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + bias[:, None, None]
    y = y.to(dtype)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def batchnorm_backward_ref(dy, x, y, weight, mean, rstd, varg, *,
                           relu: bool = False, residual: bool = False):
    """The plain backward: the chain's autograd in closed form, given the
    forward's output ``y`` (whose zeros are the ReLU's mask) and its
    statistics. ``(dx, dweight, dbias, dresidual or None)``; ``varg`` (1
    where the variance's gradient flows, 0 where its clamp bit) None is
    the eval form."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    g = dy.to(acc)
    if relu:
        g = torch.where(y <= 0, torch.zeros_like(g), g)
    xhat = (x.to(acc) - _col(mean)) * _col(rstd)
    sg = g.sum(dim=(0, 2, 3))
    sgx = (g * xhat).sum(dim=(0, 2, 3))
    a = rstd * weight
    if varg is None:
        dx = g * _col(a)
    else:
        count = x.numel() // x.shape[1]
        dx = _col(a) * (g - _col(sg / count) - xhat * _col(sgx * varg / count))
    return (dx.to(x.dtype), sgx, sg,
            g.to(dy.dtype) if residual else None)


# -- the kernels -------------------------------------------------------------


def _library() -> ctypes.CDLL:
    from skin_image_analysis_tpu_torch.ops.kernels import build

    lib = build.load("batchnorm_kernel")
    if lib.sia_bn_train_forward.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sia_bn_train_forward.argtypes = (
            [p] * 12 + [i] * 5 + [p] + [f] * 3 + [p])
        lib.sia_bn_eval_forward.argtypes = [p] * 8 + [i] * 5 + [p, f, p]
        lib.sia_bn_backward.argtypes = [p] * 14 + [i] * 5 + [p, p]
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
    n: int
    c: int
    hw: int
    plan: PlanePlan

    def check(self, name: str, t: torch.Tensor, like: torch.Tensor) -> None:
        """``t`` is an activation of ``like``'s type and shape."""
        _check(name, t, like.dtype, tuple(like.shape), like.device)

    def args(self):
        return (self.n, self.c, self.hw,
                (ctypes.c_int * 4)(*self.plan.args()))


def _geometry(x: torch.Tensor) -> _Geometry:
    """Shape and plan of a CUDA activation the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32, bfloat16 or float16, got "
                         f"{x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    n, c, h, w = x.shape
    geo = _Geometry(n, c, h * w, bn_plan(n, c, h * w, x.element_size()))
    geo.check("x", x, x)
    if geo.plan.chunks > 65535:
        raise ValueError(f"{geo.plan.chunks} chunks exceed the grid")
    return geo


def _check_epilogue(relu: bool, residual: bool) -> None:
    if residual and not relu:
        raise ValueError("the residual epilogue is the add and the ReLU: "
                         "pass relu=True with it")


def _check_params(c: int, dev: torch.device, **vectors) -> None:
    for name, v in vectors.items():
        _check(name, v, torch.float32, (c,), dev, aligned=False)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"batchnorm {what} kernel launch failed: CUDA "
                           f"error {err}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def batchnorm_train_forward(x, weight, bias, running_mean, running_var, *,
                            momentum: float, eps: float, relu: bool = False,
                            residual=None):
    """Train-mode forward: ``(y, mean, rstd, varg)`` (y like x, the rest
    float32 ``[C]``), the running averages moved in place. Not
    differentiable (:func:`batchnorm` is)."""
    _check_epilogue(relu, residual is not None)
    geo = _geometry(x)
    c, dev = geo.c, x.device
    _check_params(c, dev, weight=weight, bias=bias,
                  running_mean=running_mean, running_var=running_var)
    if residual is not None:
        geo.check("residual", residual, x)
    y = torch.empty_like(x)
    stats = torch.empty((4, c), dtype=torch.float32, device=dev)
    mean, rstd, varg, mul = stats
    partial = torch.empty((c, geo.plan.chunks, 2), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        err = _library().sia_bn_train_forward(
            x.data_ptr(), _ptr(residual), y.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), varg.data_ptr(),
            mul.data_ptr(), partial.data_ptr(), _DTYPE_CODE[x.dtype],
            int(relu), *geo.args(), eps, momentum, 1 - momentum,
            _stream(dev))
    _raise_on(err, "train forward")
    batchnorm_train_forward.launches += 1
    return y, mean, rstd, varg


def batchnorm_eval_forward(x, weight, bias, running_mean, running_var, *,
                           eps: float, relu: bool = False, residual=None,
                           rstd: torch.Tensor | None = None):
    """Eval-mode forward with the running statistics: y like x. Where
    ``rstd`` (float32 ``[C]``) is given, the kernel writes ``rsqrt(
    running_var + eps)`` into it, for the backward."""
    _check_epilogue(relu, residual is not None)
    geo = _geometry(x)
    c, dev = geo.c, x.device
    _check_params(c, dev, weight=weight, bias=bias,
                  running_mean=running_mean, running_var=running_var)
    if rstd is not None:
        _check_params(c, dev, rstd=rstd)
    if residual is not None:
        geo.check("residual", residual, x)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = _library().sia_bn_eval_forward(
            x.data_ptr(), _ptr(residual), y.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), _ptr(rstd), _DTYPE_CODE[x.dtype],
            int(relu), *geo.args(), eps, _stream(dev))
    _raise_on(err, "eval forward")
    batchnorm_eval_forward.launches += 1
    return y


def batchnorm_backward(dy, x, out, weight, bias, mean, rstd, varg, *,
                       relu: bool = False, residual: bool = False):
    """Backward of either forward: ``(dx, dweight, dbias, dresidual or
    None)``. ``out`` is the forward's output, read only behind the
    residual with its ReLU; ``varg`` None is the eval form."""
    _check_epilogue(relu, residual)
    geo = _geometry(x)
    c, dev, plan = geo.c, x.device, geo.plan
    geo.check("dy", dy, x)
    if residual:
        if out is None:
            raise ValueError("the residual's ReLU needs the output")
        geo.check("out", out, x)
    _check_params(c, dev, weight=weight, bias=bias, mean=mean, rstd=rstd)
    if varg is not None:
        _check_params(c, dev, varg=varg)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if residual else None
    grads = torch.empty((2, c), dtype=torch.float32, device=dev)
    scratch = torch.empty((c * (2 * plan.chunks + 3),), dtype=torch.float32,
                          device=dev)
    split = 2 * c * plan.chunks
    partial, coef = scratch[:split], scratch[split:]
    with torch.cuda.device(dev):
        err = _library().sia_bn_backward(
            x.data_ptr(), dy.data_ptr(),
            out.data_ptr() if residual else None, mean.data_ptr(),
            rstd.data_ptr(), _ptr(varg), weight.data_ptr(), bias.data_ptr(),
            dx.data_ptr(), _ptr(dres), grads[0].data_ptr(),
            grads[1].data_ptr(), partial.data_ptr(), coef.data_ptr(),
            _DTYPE_CODE[x.dtype], int(relu), *geo.args(), _stream(dev))
    _raise_on(err, "backward")
    batchnorm_backward.launches += 1
    return dx, grads[0], grads[1], dres


# Calls that launched the kernels since the count was last set to 0 (a
# train forward or a backward is three launches, an eval forward one).
batchnorm_train_forward.launches = 0
batchnorm_eval_forward.launches = 0
batchnorm_backward.launches = 0


class _BatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                train, momentum, eps, relu):
        if train:
            y, mean, rstd, varg = batchnorm_train_forward(
                x, weight, bias, running_mean, running_var,
                momentum=momentum, eps=eps, relu=relu, residual=residual)
        else:
            rstd = torch.empty_like(running_var)
            y = batchnorm_eval_forward(x, weight, bias, running_mean,
                                       running_var, eps=eps, relu=relu,
                                       residual=residual, rstd=rstd)
            mean, varg = running_mean.clone(), None
        ctx.relu, ctx.residual = relu, residual is not None
        out = y if residual is not None else None
        ctx.save_for_backward(x, weight, bias, mean, rstd, varg, out)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd, varg, out = ctx.saved_tensors
        dx, dw, db, dres = batchnorm_backward(
            dy.contiguous(), x, out, weight, bias, mean, rstd, varg, relu=ctx.relu,
            residual=ctx.residual)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                db if need[2] else None, dres if need[3] else None,
                None, None, None, None, None, None)


def batchnorm(x, weight, bias, running_mean, running_var, *, train: bool,
              momentum: float, eps: float, relu: bool = False,
              residual=None) -> torch.Tensor:
    """Flax's BatchNorm with the epilogue on the card, differentiable in x,
    weight, bias and residual. In training the statistics are this call's rows' and the
    running averages move in place; in eval the running statistics
    normalize."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, bias, residual)):
        return _BatchNorm.apply(x, weight, bias, residual, running_mean,
                                running_var, train, momentum, eps, relu)
    if train:
        return batchnorm_train_forward(
            x, weight, bias, running_mean, running_var, momentum=momentum,
            eps=eps, relu=relu, residual=residual)[0]
    return batchnorm_eval_forward(x, weight, bias, running_mean, running_var,
                                  eps=eps, relu=relu, residual=residual)


def bn_bytes(n: int, c: int, hw: int, elem_bytes: int = 2, *,
             form: str = "train", residual: bool = False,
             relu: bool = False, passes: int = 1) -> int:
    """Device-memory bytes of one call of ``form`` (``train``, ``eval`` or
    ``backward``) over ``[n, c, hw]``, the per-channel vectors left out.
    With ``passes`` 1, the function's own: each input read once and each
    output written once (the train forward reads x and writes y, the
    backward reads x and dy, behind the residual's ReLU the output too, and
    writes dx and the residual's gradient; a residual adds a read to the
    forwards). With ``passes`` 2, the two-pass design's floor: the train
    forward reads x twice (statistics, then apply), the backward x, dy (and
    the output) twice (reduction, then apply)."""
    if form not in ("train", "eval", "backward") or passes not in (1, 2):
        raise ValueError(f"form {form!r} must be train, eval or backward "
                         f"and passes 1 or 2, got {passes}")
    t = n * c * hw * elem_bytes
    twice = passes if form != "eval" else 1
    if form == "backward":
        return t * (twice * (2 + (relu and residual)) + 1 + residual)
    return t * (twice + 1 + residual)


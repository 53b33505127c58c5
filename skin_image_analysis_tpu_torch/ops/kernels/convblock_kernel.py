"""Fused phase-packed conv0: the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd Function around them.

The first conv block of the flagship model, conv 7x7 3->32 SAME + bias +
ReLU + 2x2 max-pool, computed as the pool-phase-packed stride-2 conv
(``ops.pooling.phase_packed_conv_block``): packed channel ``p*32 + co``
holds phase ``p = 2*di + dj`` of the pool window, so the pool is a max over
four channel groups. The kernels (``csrc/convblock_kernel.cu``) replace the
Pallas TPU kernels ``_fwd_call`` and ``_dw_call`` of the JAX package's
``ops/pallas/convblock_kernel.py``:

- :func:`fused_phase_conv0_fwd` computes the packed GEMM ``[128, 192] @
  [192, positions]`` with float32 accumulation and stores only the bf16
  pooled values and the uint8 selector (the phase of the first maximum,
  or 4 where the window's maximum is <= 0). The 4x pre-pool output never
  reaches device memory. Persistent blocks (:func:`fwd_plan`) each walk a
  contiguous range of (image, band of pooled rows) tiles.
- :func:`fused_phase_conv0_dw` computes per-image float32 partials of the
  packed weight gradient, ``(g masked by sel == phase) @ patches^T``, each
  image a cluster of :func:`dw_plan`'s blocks that split its pooled rows
  and sum their partials over distributed shared memory in a fixed order.

:func:`fused_phase_conv0` is the ``torch.autograd.Function``: the forward
kernel, then dW from the dW kernel, db from the live windows and, only
when x needs it, dx from a transposed conv of the selector-masked
cotangent. Layout is NCHW: x ``[B, 3, H, W]`` (H, W even), the weight OIHW
``[32, 3, 7, 7]``, the output ``[B, 32, H/2, W/2]`` bf16. The packed
weight ``[128, 192]`` has contraction index ``k = (a*8 + b)*3 + c`` for
tap ``(a, b)`` of the 8x8 packed kernel and input channel ``c``, as in
the JAX package.

Each kernel wrapper launches its kernel for CUDA tensors and runs its
plain version for CPU tensors. There is no fallback: a CUDA input that
the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from skin_image_analysis_tpu_torch.ops.pooling import (
    _select,
    phase_pack_kernel,
)
from skin_image_analysis_tpu_torch.ops.pooling import (
    space_to_depth as _space_to_depth,
)

_K = 7                    # kernel size of conv0
_KP = _K + 1              # packed stride-2 kernel size
_CIN = 3
_COUT = 32
_PC = 4 * _COUT           # phase-packed channels
_KDIM = _KP * _KP * _CIN  # contraction depth, 192
_DEAD = 4

# The shared-memory budget of a block (227 KB less the static reserve).
SMEM_LIMIT = 227 * 1024 - 1024
# The dW kernel's plan: the most blocks per image (its cluster, at most
# the portable 8) and pooled rows per band.
DW_MAX_CLUSTER = 8
DW_ROWS = 2
# The forward kernel's pooled rows per tile. An SM holds one of its blocks
# (two warpgroups at 219-244 registers a thread).
FWD_ROWS = 16
# Its fixed shared memory: the packed weight, the bias, and 8 warps' two
# [32, 24] bf16 epilogue tiles.
_FWD_FIXED_SMEM = 2 * _PC * _KDIM + 4 * _PC + 8 * 2 * _COUT * 24 * 2
_DW_X_OFF = 8           # shared column of input column 0
_DW_TILE = _KDIM + 4    # float row of the reduction tile


class DwPlan(NamedTuple):
    """How the dW kernel splits one image (see :func:`dw_plan`)."""

    cluster: int     # blocks per image: 1, 2, 4 or 8
    band_rows: int   # pooled rows per band
    smem_bytes: int  # dynamic shared memory a block

    def shares(self, h2: int) -> list[tuple[int, int]]:
        """The pooled rows ``[lo, hi)`` that each block of an image with
        ``h2`` pooled rows takes: a contiguous share of its bands."""
        nb = -(-h2 // self.band_rows)
        return [(min(r * nb // self.cluster * self.band_rows, h2),
                 min((r + 1) * nb // self.cluster * self.band_rows, h2))
                for r in range(self.cluster)]


def dw_smem_bytes(band_rows: int, w: int) -> int:
    """The dW kernel's shared memory for bands of ``band_rows`` pooled rows
    of width ``w``: the larger of the staging (masked cotangent, x band,
    position table) and the float32 reduction tile. The kernel's launch
    computes the same (``dw_smem_bytes`` in ``csrc/convblock_kernel.cu``,
    reported by :func:`dw_kernel_info`; a card test holds the two equal);
    this copy lets the plan be made and tested without the card."""
    tpad = -(-band_rows * (w // 2) // 16) * 16
    xstride = -(-(w + _DW_X_OFF + 3) // 8) * 8
    staging = (2 * (_PC * (tpad + 8) + 3 * (2 * band_rows + 6) * xstride)
               + 4 * tpad)
    return max(staging, 4 * _PC * _DW_TILE)


def dw_plan(w: int, batch: int, sms: int) -> DwPlan:
    """The dW kernel's plan for ``batch`` images of width ``w`` on a card
    of ``sms`` SMs.

    Blocks per image: the most, up to :data:`DW_MAX_CLUSTER`, that keep
    the grid within one block an SM, since one block keeps an SM busy. On
    an H100 (132 SMs; PERF.md, the rig's ``dwclusters``) that is 1 at
    B=256 (0.652 ms, as fast as 2), 2 at B=64 (0.250 ms; 4 took 0.286) and
    8 at B=16 (0.090 ms; 1 took 0.482). Bands of :data:`DW_ROWS` pooled
    rows, halved while a band exceeds :data:`SMEM_LIMIT`."""
    cluster = 1
    while cluster < DW_MAX_CLUSTER and 2 * cluster * batch <= sms:
        cluster *= 2
    rows = DW_ROWS
    while dw_smem_bytes(rows, w) > SMEM_LIMIT:
        if rows == 1:
            raise ValueError(f"width {w} does not fit the dW kernel's "
                             f"shared memory")
        rows //= 2
    return DwPlan(cluster, rows, dw_smem_bytes(rows, w))


class FwdPlan(NamedTuple):
    """How the forward kernel splits a batch (see :func:`fwd_plan`)."""

    band_rows: int      # pooled rows per tile
    blocks_per_sm: int  # persistent blocks an SM
    smem_bytes: int     # dynamic shared memory a block

    def tiles(self, batch: int, h2: int) -> int:
        """The (image, band) tiles of ``batch`` images of ``h2`` pooled
        rows."""
        return batch * -(-h2 // self.band_rows)

    def grid(self, batch: int, h2: int, sms: int) -> int:
        """Persistent blocks on a card of ``sms`` SMs: at most one a
        tile."""
        return min(self.tiles(batch, h2), self.blocks_per_sm * sms)


def fwd_smem_bytes(band_rows: int, w: int) -> int:
    """The forward kernel's shared memory for tiles of ``band_rows``
    pooled rows of width ``w``: the weight, bias and epilogue tiles, the
    bf16 x band and the raw stage its rows land in (sized for float32).
    The kernel's launch computes the same (``fwd_smem_bytes`` in
    ``csrc/convblock_kernel.cu``, reported by :func:`fwd_kernel_info`; a
    card test holds the two equal)."""
    xrows = 3 * (2 * band_rows + 6)
    band_stride = -(-(w + 6) // 8) * 8
    raw_stride = -(-w // 8) * 8
    return _FWD_FIXED_SMEM + xrows * (2 * band_stride + 4 * raw_stride)


def fwd_plan(w: int, batch: int, sms: int) -> FwdPlan:
    """The forward kernel's plan for ``batch`` images of width ``w`` on a
    card of ``sms`` SMs: tiles of :data:`FWD_ROWS` pooled rows (halved
    while a tile's shared memory exceeds :data:`SMEM_LIMIT`), one block an
    SM. Measured on an H100 (PERF.md, the rig's ``fwdplans``): 16 rows beat
    8 and 4 at B=256 and at B=16."""
    rows = FWD_ROWS
    while fwd_smem_bytes(rows, w) > SMEM_LIMIT:
        if rows == 1:
            raise ValueError(f"width {w} does not fit the forward kernel's "
                             f"shared memory")
        rows //= 2
    return FwdPlan(rows, 1, fwd_smem_bytes(rows, w))


def sm_count(dev: torch.device) -> int:
    """The number of SMs of CUDA device ``dev``."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _pack_w(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[32, 3, 7, 7]`` -> the bf16 packed weight ``[128, 192]``
    with ``pc = p*32 + co`` and ``k = (a*8 + b)*3 + c``."""
    wp = phase_pack_kernel(w.to(torch.bfloat16))   # [128, 3, 8, 8]
    return wp.permute(0, 2, 3, 1).reshape(_PC, _KDIM).contiguous()


def _unpack_dw(dwp2: torch.Tensor) -> torch.Tensor:
    """The cotangent of :func:`_pack_w`: ``[128, 192]`` -> OIHW
    ``[32, 3, 7, 7]`` (the transpose of the layout change and of
    ``phase_pack_kernel``'s shifted copies)."""
    dwp = dwp2.reshape(4, _COUT, _KP, _KP, _CIN)
    out = sum(dwp[p, :, di:di + _K, dj:dj + _K, :]
              for p, (di, dj) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))))
    return out.permute(0, 3, 1, 2)


def _packed_conv_weight(wp2: torch.Tensor) -> torch.Tensor:
    """``[128, 192]`` -> the float32 conv weight ``[128, 3, 8, 8]``."""
    return wp2.float().reshape(_PC, _KP, _KP, _CIN).permute(0, 3, 1, 2)


def packed_conv0_y4(x: torch.Tensor, wp2: torch.Tensor,
                    bias4: torch.Tensor) -> torch.Tensor:
    """The float32 pre-pool output ``[B, 128, H/2, W/2]`` that the forward
    kernel keeps out of device memory: x and the weight rounded to bf16,
    products summed in float32, then the float32 bias."""
    xb = F.pad(x.to(torch.bfloat16).float(), (3, 4, 3, 4))
    y4 = F.conv2d(xb, _packed_conv_weight(wp2), stride=2)
    return y4 + bias4.float()[None, :, None, None]


def fused_phase_conv0_ref(x: torch.Tensor, wp2: torch.Tensor,
                          bias4: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(pooled bf16, sel uint8)``,
    each ``[B, 32, H/2, W/2]``. The selector is taken in float32 on the
    biased packed output; the pooled value is rounded to bf16 once."""
    y4 = packed_conv0_y4(x, wp2, bias4)
    yr = y4.view(y4.shape[0], 4, _COUT, *y4.shape[2:])
    pooled, sel = _select(yr[:, 0], yr[:, 1], yr[:, 2], yr[:, 3])
    return pooled.to(torch.bfloat16).contiguous(), sel.contiguous()


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """The phase split of x: ``[B, 3, H, W]`` -> ``[B, 12, H/2, W/2]``
    bf16, plane ``(c*2 + row phase)*2 + column phase``. The JAX
    function pads the planes' lanes to 128 for Mosaic's tiled loads; the
    CUDA kernels read x's phases themselves and need no such copy."""
    return _space_to_depth(x.to(torch.bfloat16))


def _patches(xb: torch.Tensor) -> torch.Tensor:
    """``[B, 192, positions]`` float32 patches of bf16 x, in the packed
    weight's contraction order ``k = (a*8 + b)*3 + c``."""
    b = xb.shape[0]
    cols = F.unfold(F.pad(xb.float(), (3, 4, 3, 4)), _KP, stride=2)
    return (cols.view(b, _CIN, _KP * _KP, -1).transpose(1, 2)
            .reshape(b, _KDIM, -1))


def fused_phase_conv0_dw_ref(xb: torch.Tensor, g: torch.Tensor,
                             sel: torch.Tensor) -> torch.Tensor:
    """Plain version of the dW kernel: per-image float32 partials
    ``[B, 128, 192]`` of the packed weight gradient, the bf16 cotangent
    masked per phase by the selector, contracted with the bf16 patches."""
    b = g.shape[0]
    phase = torch.arange(4, dtype=torch.uint8, device=sel.device)
    dy4 = torch.where(sel[:, None] == phase.view(1, 4, 1, 1, 1),
                      g.float()[:, None], 0.0).reshape(b, _PC, -1)
    return torch.bmm(dy4, _patches(xb).transpose(1, 2))


def _check(name: str, t: torch.Tensor, dtypes: tuple, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _geometry(x: torch.Tensor) -> tuple[int, int, int]:
    if x.dim() != 4 or x.shape[1] != _CIN:
        raise ValueError(f"x must be [B, {_CIN}, H, W], got "
                         f"{tuple(x.shape)}")
    b, _, h, w = x.shape
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"H and W must be even and positive, got {h}x{w}")
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} must be in (0, 65535]")
    return b, h, w


def _library() -> ctypes.CDLL:
    from skin_image_analysis_tpu_torch.ops.kernels import build

    lib = build.load("convblock_kernel")
    if lib.sia_phase_conv0_fwd.argtypes is None:
        lib.sia_phase_conv0_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.sia_phase_conv0_fwd_info.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.sia_phase_conv0_dw.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.sia_phase_conv0_dw_info.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def fused_phase_conv0_fwd(x: torch.Tensor, wp2: torch.Tensor,
                          bias4: torch.Tensor, plan: FwdPlan | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, 3, H, W]`` float32 or bf16 (H, W even), wp2 ``[128, 192]``
    bf16 (:func:`_pack_w`), bias4 ``[128]`` float32 -> ``(pooled, sel)``,
    each ``[B, 32, H/2, W/2]``, bf16 and uint8. ``plan`` defaults to
    :func:`fwd_plan` for this batch and card; the rig and the tests pass
    others."""
    if plan is not None and (plan.band_rows < 1 or plan.blocks_per_sm < 1):
        raise ValueError(f"plan {plan} needs band_rows and blocks_per_sm "
                         f">= 1")
    if x.device.type == "cpu":
        return fused_phase_conv0_ref(x, wp2, bias4)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, h, w = _geometry(x)
    dev = x.device
    _check("x", x, (torch.float32, torch.bfloat16), (b, _CIN, h, w), dev)
    _check("wp2", wp2, (torch.bfloat16,), (_PC, _KDIM), dev)
    _check("bias4", bias4, (torch.float32,), (_PC,), dev)
    pooled = torch.empty((b, _COUT, h // 2, w // 2), dtype=torch.bfloat16,
                         device=dev)
    sel = torch.empty((b, _COUT, h // 2, w // 2), dtype=torch.uint8,
                      device=dev)
    sms = sm_count(dev)
    plan = plan or fwd_plan(w, b, sms)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sia_phase_conv0_fwd(
            x.data_ptr(), wp2.data_ptr(), bias4.data_ptr(), pooled.data_ptr(),
            sel.data_ptr(), b, h, w, int(x.dtype == torch.bfloat16),
            plan.band_rows, plan.grid(b, h // 2, sms), stream)
    _raise_on(err, "phase conv0 forward")
    fused_phase_conv0_fwd.launches += 1
    return pooled, sel


def fused_phase_conv0_dw(xb: torch.Tensor, g: torch.Tensor,
                         sel: torch.Tensor,
                         plan: DwPlan | None = None) -> torch.Tensor:
    """xb ``[B, 3, H, W]`` bf16, g ``[B, 32, H/2, W/2]`` bf16, sel the
    forward's uint8 selector -> per-image packed weight-gradient partials
    ``[B, 128, 192]`` float32 (summed by the caller). ``plan`` defaults to
    :func:`dw_plan` for this batch and card; the rig and the tests pass
    others."""
    if plan is not None and plan.cluster not in (1, 2, 4, 8):
        raise ValueError(f"cluster {plan.cluster} must be 1, 2, 4 or 8")
    if xb.device.type == "cpu":
        return fused_phase_conv0_dw_ref(xb, g, sel)
    if xb.device.type != "cuda":
        raise ValueError(f"unsupported device {xb.device}")
    b, h, w = _geometry(xb)
    dev = xb.device
    out_shape = (b, _COUT, h // 2, w // 2)
    _check("xb", xb, (torch.bfloat16,), (b, _CIN, h, w), dev)
    _check("g", g, (torch.bfloat16,), out_shape, dev)
    _check("sel", sel, (torch.uint8,), out_shape, dev)
    plan = plan or dw_plan(w, b, sm_count(dev))
    dwp = torch.empty((b, _PC, _KDIM), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sia_phase_conv0_dw(xb.data_ptr(), g.data_ptr(),
                                     sel.data_ptr(), dwp.data_ptr(), b, h, w,
                                     plan.cluster, plan.band_rows, stream)
    _raise_on(err, "phase conv0 dW")
    fused_phase_conv0_dw.launches += 1
    return dwp


def fwd_kernel_info(w: int = 224, batch: int = 256,
                    x_dtype: torch.dtype = torch.float32) -> dict:
    """What the build made of the forward kernel for ``x_dtype`` input,
    from the CUDA runtime: registers and local (spill) bytes a thread,
    threads a block, the blocks and warps an SM holds, and the shared
    memory a block, with the plan for ``batch`` images of width ``w`` on
    the current card."""
    plan = fwd_plan(w, batch, sm_count(torch.device("cuda")))
    out = (ctypes.c_int * 5)()
    _raise_on(_library().sia_phase_conv0_fwd_info(
        plan.band_rows, w, int(x_dtype == torch.bfloat16), out),
        "phase conv0 forward attribute query")
    regs, local, threads, blocks, smem = out
    return {"registers": regs, "local_bytes": local, "threads": threads,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "band_rows": plan.band_rows,
            "plan_blocks_per_sm": plan.blocks_per_sm, "smem_bytes": smem}


def dw_kernel_info(w: int = 224, batch: int = 256) -> dict:
    """What the build made of the dW kernel, from the CUDA runtime:
    registers and local (spill) bytes a thread, threads a block, the
    blocks and warps an SM holds, and the shared memory a block, with the
    plan for ``batch`` images of width ``w`` on the current card."""
    plan = dw_plan(w, batch, sm_count(torch.device("cuda")))
    out = (ctypes.c_int * 5)()
    _raise_on(_library().sia_phase_conv0_dw_info(plan.band_rows, w, out),
              "phase conv0 dW attribute query")
    regs, local, threads, blocks, smem = out
    return {"registers": regs, "local_bytes": local, "threads": threads,
            "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "cluster": plan.cluster, "band_rows": plan.band_rows,
            "smem_bytes": smem}


# Kernel launches since the count was last set to 0. CPU calls, which run
# the plain versions, do not count.
fused_phase_conv0_fwd.launches = 0
fused_phase_conv0_dw.launches = 0


class _FusedPhaseConv0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        wp2 = _pack_w(w)
        bias4 = bias.float().repeat(4)
        pooled, sel = fused_phase_conv0_fwd(x.contiguous(), wp2, bias4)
        ctx.save_for_backward(x.to(torch.bfloat16), w, sel)
        ctx.dtypes = (x.dtype, bias.dtype)
        return pooled

    @staticmethod
    def backward(ctx, g):
        xb, w, sel = ctx.saved_tensors
        x_dtype, bias_dtype = ctx.dtypes
        dx = dw = db = None
        if ctx.needs_input_grad[1]:
            dwp = fused_phase_conv0_dw(
                xb.contiguous(), g.to(torch.bfloat16).contiguous(), sel)
            dw = _unpack_dw(torch.sum(dwp, dim=0)).to(w.dtype)
        if ctx.needs_input_grad[2]:
            # dy4 sums over the phases to g where the window is live
            db = (g.float() * (sel != _DEAD)).sum(dim=(0, 2, 3))
            db = db.to(bias_dtype)
        if ctx.needs_input_grad[0]:
            b = g.shape[0]
            phase = torch.arange(4, dtype=torch.uint8, device=sel.device)
            dy4 = torch.where(sel[:, None] == phase.view(1, 4, 1, 1, 1),
                              g.float()[:, None], 0.0)
            dy4 = dy4.reshape(b, _PC, *g.shape[2:])
            dx = F.conv_transpose2d(dy4, phase_pack_kernel(w.float()),
                                    stride=2, padding=3).to(x_dtype)
        return dx, dw, db


def fused_phase_conv0(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """x ``[B, 3, H, W]`` float (H, W even), w OIHW ``[32, 3, 7, 7]``,
    bias ``[32]`` -> pooled ``[B, 32, H/2, W/2]`` bf16: conv(SAME, stride
    1) + bias + ReLU + 2x2 max-pool with x and w rounded to bf16 and
    float32 accumulation. Differentiable in x, w and bias."""
    return _FusedPhaseConv0.apply(x, w, bias)

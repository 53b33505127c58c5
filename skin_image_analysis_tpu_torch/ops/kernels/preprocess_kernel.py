"""Fused uint8 planar preprocess: the CUDA kernel's wrapper and its plain
PyTorch twin.

The kernel (``csrc/preprocess_kernel.cu``) replaces the Pallas TPU kernel
``fused_preprocess_planar`` of the JAX package: per image, gather arena row
``rows[i]``, crop ``T x T`` at ``(y0, x0)``, flip horizontally when
``flips[i]``, apply ``scale * u8 + bias`` per channel and, when the jitter
tail is given, contrast around the whole-crop mean, Rec.601 saturation,
clip to [0, 1] and a post affine. The output is NCHW-contiguous, planar
``[B, C, T, T]`` or, with ``space_to_depth``, ``[B, 4C, T/2, T/2]`` with
channel index ``c*4 + 2*dy + dx``.

:func:`fused_preprocess_planar` launches the kernel for CUDA tensors and
runs :func:`fused_preprocess_planar_ref` for CPU tensors. There is no
fallback: a CUDA input that the kernel does not take raises. The kernel is
one launch: each image is a cluster of :func:`band_plan`'s blocks, each
block a band of crop rows that it reads from the arena once. A tailed
crop whose bands do not fit one cluster (above 769 px) takes two: a sums
launch, then the band launch without a cluster.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_LUMA = (0.299, 0.587, 0.114)

# Bands (blocks) per image: with the tail, the size of an image's cluster;
# without it, where bands need not meet, one band per image. Chosen by
# measurement on an H100 (PERF.md).
CLUSTER_BLOCKS = 2
PLAIN_BLOCKS = 1
MAX_CLUSTER = 8  # the portable cluster size
# Dynamic shared memory a block may take: 227 KB less room for the
# kernel's static arrays.
SMEM_LIMIT = 227 * 1024 - 1024


class BandPlan(NamedTuple):
    """How the kernel splits one image (see :func:`band_plan`)."""

    blocks: int          # bands, one block each
    band_rows: int       # crop rows per band (the last may be shorter)
    pitch: int           # bytes per shared row
    smem_bytes: int      # dynamic shared memory per block
    sums_launch: bool    # the tail's sums come from a launch of their own


def band_plan(crop: int, channels: int, *, space_to_depth: bool = False,
              tail: bool = False, blocks: int | None = None) -> BandPlan:
    """How the kernel splits one image.

    Block ``r`` owns crop rows ``[r * band_rows, min((r + 1) * band_rows,
    crop))`` of every channel (an even count with ``space_to_depth``, so a
    band holds whole output rows), none empty. A shared row is ``pitch``
    bytes: the 16-byte aligned span around the crop's ``crop`` columns.
    Starts from ``blocks`` bands (default :data:`CLUSTER_BLOCKS` with the
    tail, else :data:`PLAIN_BLOCKS`) and doubles them until a band fits in
    shared memory. With the tail, bands that fit one cluster of at most
    :data:`MAX_CLUSTER` exchange their sums over DSMEM (one launch); more
    bands take the sums launch (``sums_launch``): a first launch writes
    each band's exact channel sums and the band launch, without a
    cluster, adds them.
    """
    step = 2 if space_to_depth else 1
    pitch = (crop + 15 + 15) // 16 * 16
    k = blocks or (CLUSTER_BLOCKS if tail else PLAIN_BLOCKS)
    while True:
        rows = -(-crop // k)
        rows = -(-rows // step) * step
        smem = channels * rows * pitch + 16
        if smem <= SMEM_LIMIT:
            k = -(-crop // rows)
            return BandPlan(k, rows, pitch, smem, tail and k > MAX_CLUSTER)
        if rows <= step:
            raise ValueError(f"a {channels}-channel crop of {crop} does not "
                             f"fit the preprocess kernel's shared memory")
        k *= 2


def fused_preprocess_planar_ref(
    pixels: torch.Tensor,
    offsets: torch.Tensor,
    flips: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    rows: torch.Tensor | None = None,
    contrast: torch.Tensor | None = None,
    saturation: torch.Tensor | None = None,
    post_scale: torch.Tensor | None = None,
    post_bias: torch.Tensor | None = None,
    *,
    image_size: int = 224,
    out_dtype: torch.dtype = torch.float32,
    space_to_depth: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, operation for operation."""
    b = offsets.shape[0]
    ch = pixels.shape[1]
    t = image_size
    dev = pixels.device
    if rows is None:
        rows = torch.arange(b, device=dev)
    ar = torch.arange(t, device=dev)
    ys = offsets[:, 0].long()[:, None] + ar                       # [B, T]
    cols = torch.where(flips.long()[:, None] != 0, t - 1 - ar, ar)
    xs = offsets[:, 1].long()[:, None] + cols                     # [B, T]
    crop = pixels[
        rows.long()[:, None, None, None],
        torch.arange(ch, device=dev)[None, :, None, None],
        ys[:, None, :, None],
        xs[:, None, None, :],
    ]                                                             # [B,C,T,T]
    x = crop.float() * scale[:, :, None, None] + bias[:, :, None, None]
    if contrast is not None:
        sums = crop.sum(dim=(2, 3), dtype=torch.int64).float()    # exact
        chan_mean = scale * (sums / float(t * t)) + bias          # [B, C]
        mean = ((chan_mean[:, 0] + chan_mean[:, 1] + chan_mean[:, 2])
                / 3.0)[:, None, None, None]
        x = (x - mean) * contrast[:, None, None, None] + mean
        lw = torch.tensor(_LUMA, dtype=torch.float32, device=dev)
        gray = (lw[0] * x[:, 0:1] + lw[1] * x[:, 1:2]) + lw[2] * x[:, 2:3]
        x = (x - gray) * saturation[:, None, None, None] + gray
        x = torch.clamp(x, 0.0, 1.0)
        x = x * post_scale[:, :, None, None] + post_bias[:, :, None, None]
    if space_to_depth:
        x = (x.reshape(b, ch, t // 2, 2, t // 2, 2)
             .permute(0, 1, 3, 5, 2, 4)
             .reshape(b, 4 * ch, t // 2, t // 2))
    return x.to(out_dtype).contiguous()


def preprocess_planar_batch(pixels: torch.Tensor, generator=None,
                            **kw) -> torch.Tensor:
    """The high-level wrapper that the JAX package keeps beside its
    kernel: ``ops.preprocess.preprocess_planar_batch`` (draws, per-image
    affine, the kernel, NHWC out), where the port keeps it."""
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        preprocess_planar_batch as planar,
    )

    return planar(pixels, generator, **kw)


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, pixels on {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _library() -> ctypes.CDLL:
    from skin_image_analysis_tpu_torch.ops.kernels import build

    lib = build.load("preprocess_kernel")
    fn = lib.sia_fused_preprocess  # returns int, ctypes' default restype
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p]
    return lib


def fused_preprocess_planar(
    pixels: torch.Tensor,
    offsets: torch.Tensor,
    flips: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    rows: torch.Tensor | None = None,
    contrast: torch.Tensor | None = None,
    saturation: torch.Tensor | None = None,
    post_scale: torch.Tensor | None = None,
    post_bias: torch.Tensor | None = None,
    *,
    image_size: int = 224,
    out_dtype: torch.dtype = torch.float32,
    space_to_depth: bool = False,
) -> torch.Tensor:
    """``[N, C, S, S]`` uint8 arena -> ``[B, C, T, T]`` (or s2d
    ``[B, 4C, T/2, T/2]``) ``out_dtype``, NCHW-contiguous.

    offsets ``[B, 2]`` int32 (y0, x0); flips ``[B]`` int32; scale/bias
    ``[B, C]`` float32; rows ``[B]`` int32 arena rows (default
    ``arange(B)``); contrast/saturation ``[B]`` and post_scale/post_bias
    ``[B, C]`` float32, all four or none, RGB only. On the card a row or
    offset outside the arena yields NaN for that image.
    """
    tail_args = (contrast, saturation, post_scale, post_bias)
    tail = contrast is not None
    if any((a is not None) != tail for a in tail_args):
        raise ValueError("contrast, saturation, post_scale and post_bias "
                         "go together")
    if pixels.device.type == "cpu":
        return fused_preprocess_planar_ref(
            pixels, offsets, flips, scale, bias, rows, contrast, saturation,
            post_scale, post_bias, image_size=image_size,
            out_dtype=out_dtype, space_to_depth=space_to_depth,
        )
    if pixels.device.type != "cuda":
        raise ValueError(f"unsupported device {pixels.device}")

    dev = pixels.device
    if pixels.dtype != torch.uint8 or pixels.dim() != 4:
        raise ValueError("pixels must be a [N, C, S, S] uint8 arena")
    n, ch, s, s2 = pixels.shape
    if s != s2 or not pixels.is_contiguous():
        raise ValueError("pixels must be square planes and contiguous")
    t = int(image_size)
    b = offsets.shape[0]
    if not 0 < t <= s:
        raise ValueError(f"image_size {t} must be in (0, {s}]")
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} must be in (0, 65535]")
    if space_to_depth and t % 2:
        raise ValueError(f"space_to_depth needs an even crop, got {t}")
    if tail and ch != 3:
        raise ValueError(f"the jitter tail needs 3 channels, got {ch}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    if rows is None:
        if b > n:
            raise ValueError(f"batch {b} exceeds the arena's {n} rows")
        rows = torch.arange(b, dtype=torch.int32, device=dev)
    _check("rows", rows, torch.int32, (b,), dev)
    _check("offsets", offsets, torch.int32, (b, 2), dev)
    _check("flips", flips, torch.int32, (b,), dev)
    _check("scale", scale, torch.float32, (b, ch), dev)
    _check("bias", bias, torch.float32, (b, ch), dev)
    if tail:
        _check("contrast", contrast, torch.float32, (b,), dev)
        _check("saturation", saturation, torch.float32, (b,), dev)
        _check("post_scale", post_scale, torch.float32, (b, ch), dev)
        _check("post_bias", post_bias, torch.float32, (b, ch), dev)

    if space_to_depth:
        out = torch.empty((b, 4 * ch, t // 2, t // 2), dtype=out_dtype,
                          device=dev)
    else:
        out = torch.empty((b, ch, t, t), dtype=out_dtype, device=dev)
    plan = band_plan(t, ch, space_to_depth=space_to_depth, tail=tail)
    # the sums launch's exact per-band channel sums, [B, bands, 3]
    sums = (torch.empty((b, plan.blocks, 3), dtype=torch.int32, device=dev)
            if plan.sums_launch else None)

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sia_fused_preprocess(
            ptr(pixels), ptr(rows), ptr(offsets), ptr(flips), ptr(scale),
            ptr(bias), ptr(contrast), ptr(saturation), ptr(post_scale),
            ptr(post_bias), ptr(sums), ptr(out), n, b, ch, s, t,
            int(out_dtype == torch.bfloat16), int(space_to_depth),
            *plan[:4], stream,
        )
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: CUDA error "
                           f"{err}")
    fused_preprocess_planar.launches += 1
    return out


# Kernel launches since the count was last set to 0. CPU calls, which run
# the plain version, do not count.
fused_preprocess_planar.launches = 0

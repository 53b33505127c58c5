#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card (name and power limit from nvidia-smi), the torch and
   CUDA versions, the TF32 settings and the kernels' build time (one
   ``nvcc`` per source, all at once);
2. holds every variant of the port's CUDA preprocess kernel against its
   plain PyTorch twin on the card, at the train step's shapes and with the
   tail at a 1024 crop (the sums launch), times both and counts the device
   kernels one call launches;
3. holds the fused phase-conv0 forward kernel (float32 and bf16 input,
   and float32 at B=16) and dW kernel against their plain versions at
   B=256, 224x224 (dW also at B=16, a cluster of 8 blocks per image),
   checks that two calls of each are bit-identical, reports each kernel's
   registers, spills, plan and resident warps, and times them beside the
   unfused ``phase_packed_conv_block``;
4. trains the flagship model at full width through ``fit_arena`` (the
   port's entry point) for two epochs of a few steps, each with one eval
   pass, and checks the kernel's launch count, the losses and the
   fairness records; holds the trained model's eval path on the card
   against the same weights in float32 on the CPU; and breaks the device
   time of one k-step call down by kernel with ``torch.profiler``, with
   the preprocess kernel's device launches per step;
5. runs the ``pconv0`` stage of the port's perf-attribution rig (the path
   of the phase-conv0 kernels) at full width, with the kernels' launch
   counts set to 0 before it and checked after it, and the fused
   gradients held against the unfused path's;
6. trains the s2d-stem model briefly through ``fit_arena``, its batches
   in the space-to-depth layout from the preprocess kernel's store, and
   the flagship at image size 1024 with augment (``train_1024``);
7. lists every TPU kernel of the JAX package with its port status, then
   the ``{"kernels": [...]}`` line and the card's name and power limit;
8. ends with ``{"ok": true, "device": {...}}`` on its last line.

Each phase prints one JSON line (the ``pconv0`` phase also the rig's own
lines). Any failure raises and exits non-zero. It imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak device-memory rate by card, from NVIDIA's data sheets.
_MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
             ("H200", 4.8e12), ("H100", 3.35e12))
_F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores
_BF16_PEAK = 989e12  # H100 SXM bf16 tensor cores, dense

# The train step's operating point (the JAX package's bench.py): batch 256,
# 256x256 arena frames random-cropped to 224, K steps per call.
BATCH, K, CALLS = 256, 4, 3
ARENA_ROWS, SIZE, CROP = 2048, 256, 224
TEST_ROWS = 512
# The preprocess kernel's oversize form: a 1024 crop of 1152 frames, and
# the train_1024 phase's fit (1088 frames cropped to 1024).
BIG_ROWS, BIG_SIZE, BIG_CROP, BIG_BATCH = 64, 1152, 1024, 32

# The TPU kernels of the JAX package: (port wrapper, TPU site, port source).
TPU_KERNELS = (
    ("fused_preprocess_planar",
     "skin_image_analysis_tpu/ops/pallas/preprocess_kernel.py:189",
     "skin_image_analysis_tpu_torch/csrc/preprocess_kernel.cu"),
    ("fused_phase_conv0_fwd",
     "skin_image_analysis_tpu/ops/pallas/convblock_kernel.py:235",
     "skin_image_analysis_tpu_torch/csrc/convblock_kernel.cu"),
    ("fused_phase_conv0_dw",
     "skin_image_analysis_tpu/ops/pallas/convblock_kernel.py:270",
     "skin_image_analysis_tpu_torch/csrc/convblock_kernel.cu"),
)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def mem_rate(name: str) -> float:
    for key, rate in _MEM_RATE:
        if key in name:
            return rate
    return 3.35e12


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_card(torch) -> dict:
    from skin_image_analysis_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.build_all(["preprocess_kernel", "convblock_kernel"])
    build_s = time.perf_counter() - t0
    line = {
        "phase": "card",
        "nvidia_smi": nvidia_smi_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "device_name": torch.cuda.get_device_name(0),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "kernel_build_s": build_s,
    }
    emit(line)
    return line


def bf16_tol(ref):
    """One bf16 ulp of ``ref``, but at least 1e-5: near 0 the two float32
    computations may differ by the tail's float32 tolerance before the
    rounding to bf16."""
    import torch

    _, exp = torch.frexp(ref.float())  # |ref| in [2^(exp-1), 2^exp)
    return torch.clamp_min(torch.exp2((exp - 8).float()), 1e-5)


def phase_kernels(torch, batch: int, arena_rows: int, size: int,
                  crop: int) -> list[dict]:
    """Every variant of the preprocess kernel against its plain twin, at
    the train step's shapes, and the tail at a 1024 crop (the sums
    launch)."""
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        band_plan,
        fused_preprocess_planar,
        fused_preprocess_planar_ref,
    )
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from skin_image_analysis_tpu_torch.tools.perf_attrib import (
        cuda_ms,
        device_kernels,
        l2_flusher,
    )

    dev = torch.device("cuda")
    std = torch.tensor(IMAGENET_STD, device=dev)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    rate = mem_rate(torch.cuda.get_device_name(0))
    flush = l2_flusher(dev)

    def inputs(seed, b, n, side, t):
        g = torch.Generator(device=dev).manual_seed(seed)
        arena = torch.randint(0, 256, (n, 3, side, side), dtype=torch.uint8,
                              device=dev, generator=g)
        rows = torch.randint(0, n, (b,), dtype=torch.int32, device=dev,
                             generator=g)
        offsets = torch.randint(0, side - t + 1, (b, 2), dtype=torch.int32,
                                device=dev, generator=g)
        flips = torch.randint(0, 2, (b,), dtype=torch.int32, device=dev,
                              generator=g)

        def uniform(shape, half):
            return 1 - half + 2 * half * torch.rand(shape, device=dev,
                                                    generator=g)

        bright = uniform((b, 1), 0.1)
        tail_args = (uniform((b,), 0.1), uniform((b,), 0.1),
                     (1 / std).expand(b, 3).contiguous(),
                     (-mean / std).expand(b, 3).contiguous())
        return arena, rows, offsets, flips, bright, tail_args

    def check(name, v, arena, rows, offsets, flips, tail_args, t):
        b = rows.numel()
        args = (arena, offsets, flips, v["scale"], v["bias"], rows,
                *(tail_args if v["tail"] else (None,) * 4))
        kw = dict(image_size=t, out_dtype=v["out_dtype"],
                  space_to_depth=v["s2d"])
        launches_before = fused_preprocess_planar.launches
        got = fused_preprocess_planar(*args, **kw)
        torch.cuda.synchronize()
        want = fused_preprocess_planar_ref(*args, **kw)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs()
        max_err = float(err.max())
        if v["atol"] is not None:
            held = f"atol {v['atol']}"
            ok = max_err <= v["atol"]
        else:
            held = "1 bf16 ulp (at least 1e-5)"
            ok = bool((err <= bf16_tol(want)).all())
        if not ok or not torch.isfinite(got.float()).all():
            bad = (err > (v["atol"] if v["atol"] is not None
                          else bf16_tol(want))).nonzero()[:5].tolist()
            worst = [(i, float(want[tuple(i)]), float(got[tuple(i)]))
                     for i in bad]
            raise AssertionError(f"{name}: kernel disagrees with the plain "
                                 f"version (max abs err {max_err}, {held}); "
                                 f"first mismatches (index, plain, kernel): "
                                 f"{worst}")
        del want, err
        ms = cuda_ms(lambda: fused_preprocess_planar(*args, **kw), 20, flush)
        plain_ms = cuda_ms(lambda: fused_preprocess_planar_ref(*args, **kw),
                           5, flush)
        per_call = sum(ev.count for ev in device_kernels(
            lambda: fused_preprocess_planar(*args, **kw)))
        plan = band_plan(t, 3, space_to_depth=v["s2d"],
                         tail=bool(v["tail"]))
        if per_call != 1 + plan.sums_launch:
            raise AssertionError(f"{name}: {per_call} device kernels a "
                                 f"call, the plan needs "
                                 f"{1 + plan.sums_launch}")
        launches = fused_preprocess_planar.launches - launches_before
        elt = got.element_size()
        n_px = b * 3 * t * t
        # the function's bytes: the crop read once, the output written once
        moved = n_px + n_px * elt \
            + rows.numel() * 4 + offsets.numel() * 4 \
            + flips.numel() * 4 + 2 * b * 3 * 4 \
            + (2 * b * 4 + 2 * b * 3 * 4 if v["tail"] else 0)
        flops = n_px * (2 if not v["tail"] else 14)
        bytes_ms, ops_ms = moved / rate * 1e3, flops / _F32_PEAK * 1e3
        line = {
            "phase": "kernel", "variant": name,
            "shape": [b, 3, t, t], "arena": list(arena.shape),
            "form": "sums launch + band launch" if plan.sums_launch
            else "one launch" + (", clustered" if v["tail"] else ""),
            "bands": plan.blocks,
            "max_abs_err": max_err, "held": held, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": moved, "launches_in_check": launches,
            "device_kernels_per_call": per_call,
        }
        if plan.sums_launch:
            # this form's floor: its sums launch reads the crop again
            line["two_read_floor_ms"] = (moved + n_px) / rate * 1e3
        emit(line)
        return line

    b = batch
    arena, rows, offsets, flips, bright, tail_args = inputs(
        0, b, arena_rows, size, crop)
    jitter = dict(scale=(bright / 255).expand(b, 3).contiguous(),
                  bias=torch.zeros(b, 3, device=dev), tail=True)
    variants = {
        "no_tail_f32": dict(
            scale=(1 / 255 / std).expand(b, 3).contiguous(),
            bias=(-mean / std).expand(b, 3).contiguous(),
            tail=None, out_dtype=torch.float32, s2d=False, atol=1e-6),
        "tail_f32": dict(jitter, out_dtype=torch.float32, s2d=False,
                         atol=1e-5),
        "tail_bf16": dict(jitter, out_dtype=torch.bfloat16, s2d=False,
                          atol=None),
        "s2d_tail_bf16": dict(jitter, out_dtype=torch.bfloat16, s2d=True,
                              atol=None),
    }
    lines = [check(name, v, arena, rows, offsets, flips, tail_args, crop)
             for name, v in variants.items()]
    del arena
    # a 1024 crop with the tail: more bands than one cluster holds
    bb = BIG_BATCH
    arena, rows, offsets, flips, bright, tail_args = inputs(
        1, bb, BIG_ROWS, BIG_SIZE, BIG_CROP)
    big = dict(scale=(bright / 255).expand(bb, 3).contiguous(),
               bias=torch.zeros(bb, 3, device=dev), tail=True,
               out_dtype=torch.bfloat16, s2d=False, atol=None)
    lines.append(check("tail_bf16_1024", big, arena, rows, offsets, flips,
                       tail_args, BIG_CROP))
    return lines


def near_ties(y4, tol: float = 1e-4):
    """Where the plain float32 packed output's top two phases, or its max
    and 0, are within ``tol``: the positions where two float32 sums in
    different orders may pick different selectors."""
    b, pc = y4.shape[:2]
    top = y4.view(b, 4, pc // 4, *y4.shape[2:]).topk(2, dim=1).values
    return ((top[:, 0] - top[:, 1]) <= tol) | (top[:, 0].abs() <= tol)


def phase_convblock(torch, batch: int, side: int) -> list[dict]:
    """The fused phase-conv0 forward kernel (float32 and bf16 x) and dW
    kernel against their plain versions, timed beside the unfused
    ``phase_packed_conv_block`` (cuDNN) that does the same work."""
    from skin_image_analysis_tpu_torch.ops.kernels.convblock_kernel import (
        _pack_w,
        dw_kernel_info,
        fused_phase_conv0_dw,
        fused_phase_conv0_dw_ref,
        fused_phase_conv0_fwd,
        fused_phase_conv0_ref,
        fwd_kernel_info,
        packed_conv0_y4,
    )
    from skin_image_analysis_tpu_torch.ops.pooling import (
        phase_packed_conv_block,
    )
    from skin_image_analysis_tpu_torch.tools.perf_attrib import (
        cuda_ms,
        l2_flusher,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    b, s = batch, side
    x32 = torch.randn(b, 3, s, s, device=dev, generator=g)
    w = 0.1 * torch.randn(32, 3, 7, 7, device=dev, generator=g)
    bias = 0.05 * torch.randn(32, device=dev, generator=g)
    wp2, bias4 = _pack_w(w), bias.float().repeat(4)
    wb, bb = w.to(torch.bfloat16), bias.to(torch.bfloat16)
    rate = mem_rate(torch.cuda.get_device_name(0))
    flush = l2_flusher(dev)

    def bound(moved, flops):
        bytes_ms, ops_ms = moved / rate * 1e3, flops / _BF16_PEAK * 1e3
        return {"bytes": moved, "flops": flops,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    def check_fwd(name, x):
        """The forward kernel against its plain version, twice alike, timed
        beside the plain version and the unfused block."""
        n = x.shape[0]
        pooled, sel = fused_phase_conv0_fwd(x, wp2, bias4)
        torch.cuda.synchronize()
        want, want_sel = fused_phase_conv0_ref(x, wp2, bias4)
        err = (pooled.float() - want.float()).abs()
        within = bool((err <= bf16_tol(want)).all())
        mismatch = sel != want_sel
        n_mis = int(mismatch.sum())
        near = near_ties(packed_conv0_y4(x, wp2, bias4))
        off_tie = int((mismatch & ~near).sum())
        if not within or n_mis >= 1e-4 * sel.numel() or off_tie \
                or not torch.isfinite(pooled.float()).all():
            raise AssertionError(
                f"conv0 {name}: kernel disagrees with the plain version: "
                f"max abs err {float(err.max())} (1 bf16 ulp: {within}), "
                f"{n_mis} selector mismatches, {off_tie} away from a tie")
        del want, want_sel, near
        again, again_sel = fused_phase_conv0_fwd(x, wp2, bias4)
        torch.cuda.synchronize()
        if not (torch.equal(pooled, again) and torch.equal(sel, again_sel)):
            raise AssertionError(f"conv0 {name}: two calls differ")
        del again, again_sel
        ms = cuda_ms(lambda: fused_phase_conv0_fwd(x, wp2, bias4), 20, flush)
        plain_ms = cuda_ms(lambda: fused_phase_conv0_ref(x, wp2, bias4), 5,
                           flush)
        xb = x.to(torch.bfloat16)
        unfused_ms = cuda_ms(lambda: phase_packed_conv_block(xb, wb, bb), 20,
                             flush)
        moved = (x.numel() * x.element_size() + pooled.numel() * 2
                 + sel.numel() + wp2.numel() * 2 + bias4.numel() * 4)
        conv_flops = 2 * n * s * s * 32 * 3 * 49  # minimal: the 7x7 conv
        # the dense packed product the kernel computes on the tensor cores
        dense_flops = 2 * 128 * 192 * (s // 2) ** 2 * n
        line = {"phase": "convblock", "kernel": name, "shape": [n, 3, s, s],
                "max_abs_err": float(err.max()),
                "held": "pooled 1 bf16 ulp (at least 1e-5); selector "
                        "mismatches < 1e-4 of positions, only where the "
                        "plain top two phases or max and 0 are within 1e-4",
                "sel_mismatches": n_mis, "positions": sel.numel(),
                "bit_identical_twice": True,
                **fwd_kernel_info(s, n, x.dtype),
                "dense_product_floor_ms": dense_flops / _BF16_PEAK * 1e3,
                "ms": ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
                **bound(moved, conv_flops), "library_ms": None}
        emit(line)
        return line

    lines = [check_fwd("fwd_f32", x32),
             check_fwd("fwd_bf16", x32.to(torch.bfloat16)),
             # the port's default batch of 16
             check_fwd("fwd_b16", x32[:16])]

    def check_dw(xb, gcot, sel):
        """The dW kernel against its plain version, and twice alike:
        (partials, max abs error, the plain partials' max)."""
        got = fused_phase_conv0_dw(xb, gcot, sel)
        torch.cuda.synchronize()
        want = fused_phase_conv0_dw_ref(xb, gcot, sel)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= 1e-3 * scale:
            raise AssertionError(f"conv0 dW at B={xb.shape[0]}: kernel "
                                 f"disagrees with the plain version: max "
                                 f"abs err {err} > 1e-3 * {scale}")
        again = fused_phase_conv0_dw(xb, gcot, sel)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("conv0 dW: two calls differ (the partials "
                                 "must be summed in a fixed order)")
        return got, err, scale

    xb = x32.to(torch.bfloat16)
    _, sel = fused_phase_conv0_fwd(xb, wp2, bias4)
    gcot = torch.randn(sel.shape, device=dev, generator=g).to(torch.bfloat16)
    # the port's default batch of 16: a cluster of 8 blocks per image
    small = (xb[:16], gcot[:16], sel[:16])
    _, err16, scale16 = check_dw(*small)
    line16 = {"phase": "convblock", "kernel": "dw_b16",
              "shape": [16, 3, s, s], "max_abs_err": err16,
              "max_abs_plain": scale16, "bit_identical_twice": True,
              "cluster": dw_kernel_info(s, 16)["cluster"],
              "ms": cuda_ms(lambda: fused_phase_conv0_dw(*small), 20, flush)}
    emit(line16)
    got, err, scale = check_dw(xb, gcot, sel)
    info = dw_kernel_info(s, b)
    ms = cuda_ms(lambda: fused_phase_conv0_dw(xb, gcot, sel), 20, flush)
    plain_ms = cuda_ms(lambda: fused_phase_conv0_dw_ref(xb, gcot, sel), 3,
                       flush)
    wl = wb.detach().requires_grad_(True)
    bl = bb.detach().requires_grad_(True)
    y = phase_packed_conv_block(xb, wl, bl)
    unfused_ms = cuda_ms(lambda: torch.autograd.grad(
        y, (wl, bl), gcot, retain_graph=True), 20, flush)
    live = int((sel != 4).sum())  # only a live window's phase has gradient
    moved = (xb.numel() * 2 + gcot.numel() * 2 + sel.numel()
             + got.numel() * 4)
    # the masked dense product the kernel computes on the tensor cores
    dense_flops = 2 * 128 * 192 * (s // 2) ** 2 * b
    line = {"phase": "convblock", "kernel": "dw", "shape": [b, 3, s, s],
            "max_abs_err": err, "max_abs_plain": scale,
            "held": "max abs err <= 1e-3 of the plain partials' max",
            "bit_identical_twice": True, **info,
            "dense_product_floor_ms": dense_flops / _BF16_PEAK * 1e3,
            "ms": ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
            "unfused_what": "backward of phase_packed_conv_block to w, b",
            **bound(moved, 2 * 3 * 49 * live), "library_ms": None}
    emit(line)
    lines.append(line)
    return lines


def phase_pconv0(torch) -> list[dict]:
    """The phase-conv0 kernels' path: the port rig's ``pconv0`` stage at
    full width, with the launch counts set to 0 just before it. Each
    forward call launches the forward kernel once, each forward +
    backward call the forward and the dW kernel once each; the fused
    gradients agree with the unfused path's to cosine > 0.999."""
    from skin_image_analysis_tpu_torch.ops.kernels.convblock_kernel import (
        fused_phase_conv0_dw,
        fused_phase_conv0_fwd,
    )
    from skin_image_analysis_tpu_torch.tools import perf_attrib

    fused_phase_conv0_fwd.launches = 0
    fused_phase_conv0_dw.launches = 0
    lines = perf_attrib.run(["pconv0", "--batch-size", str(BATCH),
                             "--iters", "20", "--image-size", str(CROP),
                             "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"fwd": fused_phase_conv0_fwd.launches,
                "dw": fused_phase_conv0_dw.launches}
    by = {ln["stage"]: ln for ln in lines}
    fwd, fwdbwd = by["pconv0_fwd"], by["pconv0_fwdbwd"]
    with_bwd = fwdbwd["calls"] + fwdbwd["grad_check_calls"]
    want = {"fwd": fwd["calls"] + with_bwd, "dw": with_bwd}
    if launches != want:
        raise AssertionError(f"pconv0 launched {launches}, its calls need "
                             f"{want}")
    cos = min(fwdbwd["grad_cos_dw"], fwdbwd["grad_cos_db"])
    if not cos > 0.999:
        raise AssertionError(f"fused conv0 grads disagree with the unfused "
                             f"path: cosine {cos}")
    line = {"phase": "pconv0", "launches": launches,
            "fwd_calls": fwd["calls"], "fwdbwd_calls": with_bwd,
            "grad_cos_dw": fwdbwd["grad_cos_dw"],
            "grad_cos_db": fwdbwd["grad_cos_db"],
            **{name: by[name]["ms"] for name in (
                "pconv0_fwd", "pconv0_fwdbwd", "uconv0_fwd",
                "uconv0_fwdbwd")}}
    emit(line)
    return line


def _check_fit(result, launches: int, cfg, n_train: int, n_test: int):
    """The checks every fit_arena run here must pass; returns (losses,
    live train steps)."""
    import numpy as np

    from skin_image_analysis_tpu_torch.train.loop import RECORD_KEYS

    losses = np.concatenate(result.step_losses)
    counts = np.concatenate(result.step_counts)
    steps = int((counts > 0).sum())
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite train losses: {losses}")
    if launches != steps \
            or steps != cfg.epochs * n_train // cfg.data.batch_size:
        raise AssertionError(f"kernel launched {launches} times for "
                             f"{steps} train steps")
    for record in result.records:
        missing = set(RECORD_KEYS) - set(record)
        if missing:
            raise AssertionError(f"record lacks {sorted(missing)}")
        if record["total"] != n_test:
            raise AssertionError(f"eval covered {record['total']} of "
                                 f"{n_test} rows")
        for key in ("accuracy", "auc", "avg_batch_loss"):
            if not np.isfinite(record[key]):
                raise AssertionError(f"record {key} = {record[key]}")
    return losses, steps


def _fit(torch, cfg, n_train: int, n_test: int, seed: int, side: int = 256):
    """fit_arena on random arenas of ``side``² frames made on the card,
    with the preprocess kernel's launch count set to 0 just before it:
    (result, launches, wall seconds, train arena, test arena)."""
    import numpy as np

    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.train.loop import fit_arena

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    train_arena = torch.randint(0, 256, (n_train, 3, side, side),
                                dtype=torch.uint8, device=dev, generator=g)
    test_arena = torch.randint(0, 256, (n_test, 3, side, side),
                               dtype=torch.uint8, device=dev, generator=g)
    rng = np.random.default_rng(seed)
    # both classes in each arena, so that the AUCs are defined
    train_labels = rng.permutation(np.arange(n_train) % 2)
    test_labels = rng.permutation(np.arange(n_test) % 2)
    groups = {a: rng.integers(-1, 2, n_test)
              for a in ("skin_tone", "sex", "control")}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        fused_preprocess_planar.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fit_arena(cfg, train_arena, train_labels, test_arena,
                           test_labels, groups, out_dir, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_preprocess_planar.launches
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return result, launches, wall, train_arena, test_arena


def _train_config(cfg_lib, epochs: int, stem: str):
    return cfg_lib.TrainConfig(
        epochs=epochs, seed=0,
        data=cfg_lib.DataConfig(
            image_size=224, canonical_size=256, batch_size=BATCH,
            augment=True, steps_per_dispatch=K),
        model=cfg_lib.ModelConfig(compute_dtype="bfloat16", stem=stem),
        optim=cfg_lib.OptimConfig(learning_rate=1e-5,
                                  moment_dtype="bfloat16",
                                  nu_dtype="bfloat16"),
    )


def phase_train_s2d(torch) -> dict:
    """fit_arena with the s2d stem at full width: one epoch of two k-step
    calls, the preprocess kernel storing the space-to-depth layout; one
    launch per live train step."""
    from skin_image_analysis_tpu_torch import config as cfg_lib

    cfg = _train_config(cfg_lib, 1, "s2d")
    n_train = BATCH * K * 2
    result, launches, wall, _, _ = _fit(torch, cfg, n_train, BATCH, seed=3)
    losses, steps = _check_fit(result, launches, cfg, n_train, BATCH)
    line = {"phase": "train_s2d", "stem": "s2d", "steps": steps,
            "launches": launches, "loss_first": float(losses[0]),
            "loss_last": float(losses[-1]), "wall_s": wall,
            "accuracy": result.records[-1]["accuracy"]}
    emit(line)
    return line


def phase_train_1024(torch) -> dict:
    """fit_arena with augment at image_size 1024 (crops 1088 -> 1024, more
    bands than one cluster holds, so the preprocess kernel's sums launch):
    one epoch of two steps at B=4, the flagship at full width (its flatten
    dense 2.1 M x 512), and an eval pass over 8 test rows."""
    from skin_image_analysis_tpu_torch import config as cfg_lib

    b, n = 4, 8
    cfg = cfg_lib.TrainConfig(
        epochs=1, seed=0,
        data=cfg_lib.DataConfig(
            image_size=BIG_CROP, canonical_size=1088, batch_size=b,
            augment=True, steps_per_dispatch=2),
        model=cfg_lib.ModelConfig(compute_dtype="bfloat16",
                                  image_size=BIG_CROP),
        optim=cfg_lib.OptimConfig(learning_rate=1e-5,
                                  moment_dtype="bfloat16",
                                  nu_dtype="bfloat16"),
    )
    torch.cuda.reset_peak_memory_stats()
    result, launches, wall, _, _ = _fit(torch, cfg, n, n, seed=4, side=1088)
    losses, steps = _check_fit(result, launches, cfg, n, n)
    line = {"phase": "train_1024", "image_size": BIG_CROP, "frames": 1088,
            "batch": b, "steps": steps, "launches": launches,
            "losses": [float(v) for v in losses],
            "params": sum(p.numel() for p in
                          result.state.model.parameters()),
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "wall_s": wall, "accuracy": result.records[-1]["accuracy"]}
    del result
    torch.cuda.empty_cache()
    emit(line)
    return line


def phase_train(torch) -> dict:
    """fit_arena at full width: B=256, augment, random crop 256->224."""
    from skin_image_analysis_tpu_torch import config as cfg_lib

    cfg = _train_config(cfg_lib, 2, "auto")
    n_train = BATCH * K * CALLS
    result, launches, wall, train_arena, test_arena = _fit(
        torch, cfg, n_train, TEST_ROWS, seed=1)
    losses, steps = _check_fit(result, launches, cfg, n_train, TEST_ROWS)
    per_epoch = n_train // BATCH
    line = {
        "phase": "train", "steps": steps, "epochs": cfg.epochs,
        "batch": BATCH, "k": K, "launches": launches,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "train_img_per_s_by_epoch": [
            per_epoch * BATCH / r["epoch_time_s"]
            for r in result.records],
        "epoch_time_s": [r["epoch_time_s"] for r in result.records],
        "eval_time_s": [r["eval_time_s"] for r in result.records],
        "eval_img_per_s_by_epoch": [
            TEST_ROWS / r["eval_time_s"] for r in result.records],
        "wall_s": wall, "record_keys": len(result.records[-1]),
        "accuracy": result.records[-1]["accuracy"],
        "card": nvidia_smi_line(),
    }
    emit(line)
    phase_reference(torch, cfg, result.state.model, test_arena)
    phase_profile(torch, result.state, train_arena)
    return line


def phase_reference(torch, cfg, model, test_arena, n: int = 64,
                    atol: float = 5e-3) -> dict:
    """The trained model's eval path on the card (bf16 compute, cuDNN)
    against the same weights run in float32 on the CPU, on ``n`` test
    rows: log-probabilities within ``atol`` (bf16 compute), and the same
    predicted class wherever the reference's two log-probabilities differ
    by more than ``atol``."""
    import dataclasses

    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        make_preprocess_fn,
    )

    pre = make_preprocess_fn(cfg.data.image_size, train=False,
                             layout="planar")
    pixels = test_arena[:n]
    with torch.no_grad():
        model.eval()
        got = model(pre(pixels)).float().cpu()
        ref_model = build_model(
            dataclasses.replace(cfg.model, compute_dtype="float32"),
            device="cpu")
        ref_model.load_state_dict(
            {k: v.cpu() for k, v in model.state_dict().items()})
        ref_model.eval()
        want = ref_model(pre(pixels.cpu()))
    err = float((got - want).abs().max())
    decided = (want[:, 1] - want[:, 0]).abs() > atol
    flipped = int((got.argmax(1) != want.argmax(1))[decided].sum())
    if got.shape != (n, cfg.model.num_classes) \
            or not torch.isfinite(got).all() or err > atol or flipped:
        raise AssertionError(f"eval on the card disagrees with the CPU "
                             f"float32 reference: max abs err {err} "
                             f"(atol {atol}), {flipped} of "
                             f"{int(decided.sum())} decided rows change "
                             f"class, shape {tuple(got.shape)}")
    line = {"phase": "reference", "rows": n, "max_abs_err_log_probs": err,
            "atol": atol, "decided_rows": int(decided.sum()),
            "class_changes": flipped}
    emit(line)
    return line


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "preprocess" in low:
        return "preprocess kernel (port)"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout conversion (cuDNN)"
    if any(w in low for w in ("cudnn", "conv", "fprop", "dgrad", "wgrad")):
        return "convolution (cuDNN)"
    if any(w in low for w in ("gemm", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


def phase_profile(torch, state, arena) -> dict:
    """Device time by kernel and by the operator that launched it, over one
    steady k-step call of the train step, from torch.profiler, against the
    call's wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from skin_image_analysis_tpu_torch.ops.preprocess import (
        AugmentConfig,
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.train.step import multi_train_step

    pre = make_preprocess_fn(
        224, train=True,
        augment=AugmentConfig(brightness=0.1, contrast=0.1, saturation=0.1),
        layout="planar", out_dtype="bfloat16")
    rng = np.random.default_rng(5)
    idx = rng.integers(0, arena.shape[0], (K, BATCH)).astype(
        np.int32)
    labels = rng.integers(0, 2, idx.shape).astype(np.int32)
    valid = np.ones(idx.shape, bool)
    multi_train_step(state, arena, idx, labels, valid, None, pre)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        multi_train_step(state, arena, idx, labels, valid, None, pre)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels, and the host operators that launched them (an
    # operator's self device time is that of the kernels it launched)
    kernels, ops, pre_launches = {}, {}, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us <= 0:
            continue
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        table = kernels if on_device else ops
        table[ev.key] = table.get(ev.key, 0.0) + us / 1e3
        if on_device and _kernel_group(ev.key).startswith("preprocess"):
            pre_launches += ev.count
    device_ms = sum(kernels.values())
    groups = {}
    for name, ms in kernels.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms

    def top(table):
        return [[name[:90], ms] for name, ms
                in sorted(table.items(), key=lambda kv: -kv[1])[:12]]

    line = {
        "phase": "profile", "steps": K, "batch": BATCH,
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "step_ms": wall_ms / K,
        "img_per_s": K * BATCH / (wall_ms / 1e3),
        "by_group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "preprocess_launches_per_step": pre_launches / K,
        "top_kernels_ms": top(kernels),
        "top_ops_ms": top(ops),
    }
    emit(line)
    return line


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "skin_image_analysis_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = phase_card(torch)
    kernel_lines = phase_kernels(torch, BATCH, ARENA_ROWS, SIZE, CROP)
    conv_lines = {ln["kernel"]: ln
                  for ln in phase_convblock(torch, BATCH, CROP)}
    train = phase_train(torch)
    pconv0 = phase_pconv0(torch)
    phase_train_s2d(torch)
    phase_train_1024(torch)
    emit({"phase": "kernels", "table": [
        {"name": name, "replaces": site, "source": source,
         "status": "ported, held against its plain version"}
        for name, site, source in TPU_KERNELS]})
    # the train step runs the tail with bf16 output, and the pconv0 path
    # the conv0 forward on float32 x: report those variants
    main_variant = [ln for ln in kernel_lines
                    if ln["variant"] == "tail_bf16"][0]
    rows = [
        (main_variant, train["launches"],
         max(ln["max_abs_err"] for ln in kernel_lines)),
        (conv_lines["fwd_f32"], pconv0["launches"]["fwd"],
         max(conv_lines[name]["max_abs_err"]
             for name in ("fwd_f32", "fwd_bf16", "fwd_b16"))),
        (conv_lines["dw"], pconv0["launches"]["dw"],
         conv_lines["dw"]["max_abs_err"]),
    ]
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": site,
        "launches": launches, "max_abs_err": err,
        "ms": ln["ms"], "plain_ms": ln["plain_ms"],
        "bound_ms": ln["bound_ms"], "bound_by": ln["bound_by"],
        "library_ms": None,
    } for (name, site, source), (ln, launches, err)
        in zip(TPU_KERNELS, rows)]})
    print(card["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

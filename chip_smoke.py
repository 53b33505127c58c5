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
7. drives the flagship CLIs end to end (phase ``cli``): writes a cohort
   of 3,072 ISIC rows (some without a Fitzpatrick type) as 256x256 RGB
   DICOMs, trains it with ``tone_bias_train ... 2 balance --augment`` at
   full width, resumes the folder for one epoch, and scores it with
   ``tone_bias_test``; checks the folder, one preprocess-kernel launch
   per train step, the resume's state restored bit for bit, and the test
   CLI's predictions against a float32 CPU forward of the checkpoint;
8. lists every TPU kernel of the JAX package with its port status, then
   the ``{"kernels": [...]}`` line (the preprocess kernel's launches are
   the train CLI's) and the card's name and power limit;
9. ends with ``{"ok": true, "device": {...}}`` on its last line.

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


# The cli phase's cohort: ISIC rows, every 16th with no Fitzpatrick type
# ("" or "NA"), as 256x256 RGB DICOMs (native pixels, which the port
# decodes without PIL or cv2); the test CLI's root holds the test rows'
# centre 224 crops, the model's input size (the card has no resizer).
COHORT_ROWS = 3072


def _dicom_rgb(img) -> bytes:
    """An RGB uint8 frame as an explicit VR little endian DICOM."""
    import struct

    def el(group, elem, vr, value):
        if len(value) % 2:
            value += b"\0" if vr in (b"UI", b"OB") else b" "
        head = struct.pack("<HH", group, elem) + vr
        if vr == b"OB":
            return head + b"\0\0" + struct.pack("<I", len(value)) + value
        return head + struct.pack("<H", len(value)) + value

    def us(v):
        return struct.pack("<H", v)

    syntax = el(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1")
    meta = el(0x0002, 0x0000, b"UL", struct.pack("<I", len(syntax))) + syntax
    rows, cols, _ = img.shape
    body = b"".join([
        el(0x0028, 0x0002, b"US", us(3)), el(0x0028, 0x0004, b"CS", b"RGB"),
        el(0x0028, 0x0006, b"US", us(0)), el(0x0028, 0x0010, b"US", us(rows)),
        el(0x0028, 0x0011, b"US", us(cols)),
        el(0x0028, 0x0100, b"US", us(8)), el(0x0028, 0x0103, b"US", us(0)),
        el(0x7FE0, 0x0010, b"OB", img.tobytes()),
    ])
    return b"\0" * 128 + b"DICM" + meta + body


def _write_cohort(root: str, n: int, seed: int):
    """metadata.csv and one DICOM per row; returns {isic_id: frame}."""
    import csv

    import numpy as np

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    fitz = ("I", "II", "III", "IV", "V", "VI")
    ids, rows = [], []
    for i in range(n):
        isic_id = f"ISIC_{i:07d}"
        ids.append(isic_id)
        light = rng.random() < 0.5
        rows.append({
            "isic_id": isic_id, "attribution": "chip_smoke",
            "age_approx": str(int(rng.integers(20, 90))),
            "anatom_site_general": "torso",
            "benign_malignant": ("malignant" if rng.random() < 0.5
                                 else "benign"),
            "fitzpatrick_skin_type": (
                ("", "NA")[i // 16 % 2] if i % 16 == 15
                else fitz[rng.integers(0, 2) if light
                          else rng.integers(2, 6)]),
            "sex": "male" if rng.random() < 0.5 else "female",
        })
        with open(os.path.join(root, f"{isic_id}.dcm"), "wb") as f:
            f.write(_dicom_rgb(frames[i]))
    with open(os.path.join(root, "metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return dict(zip(ids, frames))


class _Patch:
    """Wrap ``obj.name`` with ``wrap(original)`` inside a with block."""

    def __init__(self, obj, name, wrap):
        self.obj, self.name, self.wrap = obj, name, wrap

    def __enter__(self):
        self.orig = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.wrap(self.orig))

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.orig)


def _read_split(folder: str, name: str) -> list[str]:
    import csv

    with open(os.path.join(folder, name), newline="") as f:
        return [row["isic_id"] for row in csv.DictReader(f)]


def phase_cli(torch) -> dict:
    """The flagship CLIs end to end on the card, in a temporary working
    directory: ``tone_bias_train <root> 2 balance --augment --batch-size
    256 --steps-per-dispatch 4 --seed 0`` (full width, 224 crops of 256
    frames, bf16), the same CLI for 1 epoch on the folder it made (a
    resume), then ``tone_bias_test`` on it. Checks the folder, finite
    losses, one preprocess-kernel launch per train step, the resume's
    state restored bit for bit, the test record over every test row, and
    the test CLI's predictions against a float32 CPU forward of the same
    checkpoint."""
    import contextlib
    import dataclasses
    import io

    import numpy as np

    from skin_image_analysis_tpu_torch.cli import tone_bias_test
    from skin_image_analysis_tpu_torch.cli import tone_bias_train
    from skin_image_analysis_tpu_torch.data.dataset import LesionTable
    from skin_image_analysis_tpu_torch.data.ingest import read_csv
    from skin_image_analysis_tpu_torch.data.loader import HostImageStore
    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt
    from skin_image_analysis_tpu_torch.train import evaluate, loop
    from skin_image_analysis_tpu_torch.utils import jsonl

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    root, root224 = os.path.join(work, "cohort"), os.path.join(work, "c224")
    os.makedirs(root)
    os.makedirs(root224)
    cwd = os.getcwd()
    log = io.StringIO()
    try:
        t0 = time.perf_counter()
        frames = _write_cohort(root, COHORT_ROWS, seed=6)
        write_s = time.perf_counter() - t0
        os.chdir(work)
        losses, restored = [], []
        spent = {}  # seconds by step of the CLI, in the current run

        def timed(key):
            def wrap(fn):
                def call(*a, **kw):
                    t = time.perf_counter()
                    out = fn(*a, **kw)
                    torch.cuda.synchronize()
                    spent[key] = spent.get(key, 0.0) \
                        + time.perf_counter() - t
                    return out
                return call
            return wrap

        def record_losses(step):
            def call(*a, **kw):
                m = step(*a, **kw)
                losses.append((m["loss"], m["count"]))  # read after the run
                return m
            return call

        def record_restore(restore):
            def call(ckpt_dir, template):
                restore(ckpt_dir, template)
                restored.append(ckpt.snapshot(template))
                return template
            return call

        def train(argv):
            fused_preprocess_planar.launches = 0
            losses.clear()
            spent.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with _Patch(loop, "multi_train_step", record_losses), \
                    _Patch(loop, "_decode_arenas", timed("decode")), \
                    _Patch(HostImageStore, "to_device", timed("upload")), \
                    _Patch(ckpt, "save_model", timed("save_model")), \
                    _Patch(ckpt, "save_train_state",
                           timed("save_train_state")), \
                    _Patch(ckpt, "restore_train_state", lambda f:
                           record_restore(timed("restore")(f))), \
                    contextlib.redirect_stdout(log):
                if tone_bias_train.main(argv) != 0:
                    raise AssertionError(f"tone_bias_train {argv} failed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = fused_preprocess_planar.launches
            step_losses = torch.cat([lo for lo, _ in losses]).cpu().numpy()
            live = torch.cat([c for _, c in losses]).cpu().numpy() > 0
            if not np.isfinite(step_losses).all():
                raise AssertionError(f"non-finite losses {step_losses}")
            # _decode_arenas decodes both splits, then uploads the arenas
            spent["decode"] -= spent["upload"]
            return (wall, launches, int(live.sum()), step_losses[live],
                    dict(spent))

        args = ["--augment", "--batch-size", str(BATCH),
                "--steps-per-dispatch", str(K), "--seed", "0"]
        wall, launches, steps, first_losses, first_spent = train(
            [root, "2", "balance", *args])
        [folder] = os.listdir(os.path.join(work, "results"))
        folder = os.path.join(work, "results", folder)
        n_train = len(_read_split(folder, loop.TRAIN_SET_FILENAME))
        test_ids = _read_split(folder, loop.TEST_SET_FILENAME)
        per_epoch = n_train // BATCH
        if launches != steps or steps != 2 * per_epoch:
            raise AssertionError(f"preprocess kernel launched {launches} "
                                 f"times for {steps} train steps "
                                 f"({per_epoch} an epoch)")
        names = set(os.listdir(folder))
        want = {loop.TRAIN_SET_FILENAME, loop.TEST_SET_FILENAME,
                "train_config.json", ckpt.MODEL_FILENAME,
                loop.CHECKPOINT_DIRNAME, loop.PROGRESS_FILENAME}
        results = sorted(n for n in names
                         if n.endswith(".json") and n[0].isdigit())
        if not want <= names or len(results) != 1:
            raise AssertionError(f"experiment folder holds {sorted(names)}")
        records = list(jsonl.read_records(os.path.join(folder, results[0])))
        if len(records) != 2 or loop.completed_epochs(folder) != 2:
            raise AssertionError(f"{len(records)} records, progress "
                                 f"{loop.completed_epochs(folder)}")
        for rec in records:
            missing = set(loop.RECORD_KEYS) - set(rec)
            if missing or rec["total"] != len(test_ids) \
                    or not np.isfinite(rec["avg_batch_loss"]):
                raise AssertionError(f"record lacks {sorted(missing)} or "
                                     f"covers {rec['total']} of "
                                     f"{len(test_ids)} rows")

        # the resume: 1 epoch on the folder, its snapshot restored exactly
        saved = ckpt.read_train_state(os.path.join(folder,
                                                   loop.CHECKPOINT_DIRNAME))
        resume_wall, resume_launches, resume_steps, _, resume_spent = train(
            [root, "1", folder, *args])
        if resume_launches != resume_steps or resume_steps != per_epoch:
            raise AssertionError(f"resume: {resume_launches} launches for "
                                 f"{resume_steps} steps")
        [snap] = restored
        same = (snap["step"] == saved["step"]
                and snap["adam_count"] == saved["adam_count"]
                and torch.equal(snap["generator"], saved["generator"])
                and all(torch.equal(snap["model"][k], v)
                        for k, v in saved["model"].items())
                and all(torch.equal(a, b) for a, b in zip(
                    snap["adam_mu"] + snap["adam_nu"],
                    saved["adam_mu"] + saved["adam_nu"])))
        new = sorted(n for n in os.listdir(folder)
                     if n.endswith(".json") and n[0].isdigit())
        if not same or len(new) != 2 or loop.completed_epochs(folder) != 3:
            raise AssertionError(f"resume: state restored bitwise {same}, "
                                 f"results files {new}, progress "
                                 f"{loop.completed_epochs(folder)}")

        # the test CLI on the test rows' 224 crops; its predictions beside
        # a float32 CPU forward of the same checkpoint
        lo = (SIZE - CROP) // 2
        for isic_id in test_ids:
            with open(os.path.join(root224, f"{isic_id}.dcm"), "wb") as f:
                f.write(_dicom_rgb(np.ascontiguousarray(
                    frames[isic_id][lo:lo + CROP, lo:lo + CROP])))
        predictions = []

        def record_predictions(collect):
            def call(*a, **kw):
                out = collect(*a, **kw)
                predictions.append(out)
                return out
            return call

        out = io.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _Patch(evaluate, "collect_predictions", record_predictions), \
                contextlib.redirect_stdout(out):
            if tone_bias_test.main([root224, folder]) != 0:
                raise AssertionError("tone_bias_test failed")
        test_cli_s = time.perf_counter() - t
        text = out.getvalue()
        log.write(text)
        record = json.loads(text[text.index("{"):text.rindex("}") + 1])
        if record["total"] != len(test_ids):
            raise AssertionError(f"test CLI covered {record['total']} of "
                                 f"{len(test_ids)} rows")
        [pred] = predictions
        n_ref, atol = min(256, len(test_ids)), 5e-3
        card = np.empty(len(test_ids), np.int64)
        card[pred["row_id"]] = pred["pred"]
        model_cfg, state_dict = ckpt.load_model(
            os.path.join(folder, ckpt.MODEL_FILENAME))
        ref_model = build_model(dataclasses.replace(
            model_cfg, compute_dtype="float32"), device="cpu")
        ref_model.load_state_dict(state_dict)
        ref_model.eval()
        table = LesionTable(read_csv(os.path.join(
            folder, loop.TEST_SET_FILENAME), index_col=True).take(
                range(n_ref)), root224)
        pixels = HostImageStore(table, CROP).to_device("cpu")
        with torch.no_grad():
            want = ref_model(make_preprocess_fn(
                CROP, train=False, layout="planar")(pixels)).float()
        decided = ((want[:, 1] - want[:, 0]).abs() > atol).numpy()
        flipped = int((want.argmax(1).numpy() != card[:n_ref])[decided]
                      .sum())
        if flipped or decided.sum() < min(64, n_ref):
            raise AssertionError(f"test CLI predictions: {flipped} of "
                                 f"{int(decided.sum())} decided rows differ "
                                 f"from the CPU float32 forward")
    except BaseException:
        print(log.getvalue()[-4000:], file=sys.stderr)
        raise
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    line = {
        "phase": "cli", "rows": COHORT_ROWS, "train_rows": n_train,
        "test_rows": len(test_ids), "epochs": 2, "batch": BATCH, "k": K,
        "steps": steps, "launches": launches,
        "resume_steps": resume_steps, "resume_launches": resume_launches,
        "resume_restored_bitwise": True,
        "loss_first": float(first_losses[0]),
        "loss_last": float(first_losses[-1]),
        "write_cohort_s": write_s,
        "decode_s": first_spent["decode"],
        "train_cli_s": first_spent, "resume_cli_s": resume_spent,
        "train_wall_s": wall, "resume_wall_s": resume_wall,
        "epoch_time_s": [r["epoch_time_s"] for r in records],
        "warm_epoch_img_per_s": per_epoch * BATCH
        / records[1]["epoch_time_s"],
        "eval_s": [r["eval_time_s"] for r in records],
        "test_cli_s": test_cli_s, "test_accuracy": record["accuracy"],
        "reference_rows": n_ref, "decided_rows": int(decided.sum()),
        "class_changes": flipped, "card": nvidia_smi_line(),
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
    cli = phase_cli(torch)
    emit({"phase": "kernels", "table": [
        {"name": name, "replaces": site, "source": source,
         "status": "ported, held against its plain version"}
        for name, site, source in TPU_KERNELS]})
    # the train step runs the tail with bf16 output, and the pconv0 path
    # the conv0 forward on float32 x: report those variants; the
    # preprocess kernel's launches are the train CLI's (run and resume)
    main_variant = [ln for ln in kernel_lines
                    if ln["variant"] == "tail_bf16"][0]
    rows = [
        (main_variant, cli["launches"] + cli["resume_launches"],
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

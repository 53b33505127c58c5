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
   unfused ``phase_packed_conv_block``; then (phase ``batchnorm``) the
   fused BatchNorm kernels (train forward, backward, eval; bf16, NCHW)
   against their plain versions (statistics, running averages, dgamma
   and dbeta included) at
   ResNet-50's stem, stage-1 and stage-4 shapes at B=256, each timed
   beside its byte bound and the two-pass floor, and every one of the
   53 layers timed and summed into the whole step's forward, backward
   and eval;
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
7. decodes a seeded 2,048-row JPEG cohort (600x450, 1024x768 and
   6000x4000 frames, grayscale frames, files that are no JPEG) through
   the port's libjpeg decoder, built with g++ from ``csrc/decoder.cc``
   (phase ``jpeg``; its libjpeg route on a line of its own, and a decoder
   that does not build fails the run): the arena against the python
   path's within a mean of 2 levels on each source size, both rates;
   then the train CLI for 2 epochs and the test CLI on that cohort (the
   store's arenas byte-equal to the decoder's, the bad files' rows
   invalid, one preprocess launch per step), ``tone_classifier_train``
   with resnet18 and ``images_to_ita`` on 256 of its frames;
   then drives the flagship CLIs end to end (phase ``cli``): writes a cohort
   of 3,072 ISIC rows (some without a Fitzpatrick type) as 256x256 RGB
   DICOMs, trains it with ``tone_bias_train ... 2 balance --augment`` at
   full width, resumes the folder for one epoch, and scores it with
   ``tone_bias_test``; checks the folder, one preprocess-kernel launch
   per train step, the resume's state restored bit for bit, and the test
   CLI's predictions against a float32 CPU forward of the checkpoint;
8. trains that cohort through ``run_training`` with the arenas on the card
   and with ``device_cache=False`` (phase ``hostfeed``: host batches, the
   preprocess kernel on each uploaded batch), side by side; checks one
   preprocess device kernel per host-fed step, the first host batch
   against the arena feed bit for bit, and the kernel's ``rows=None``
   call against its plain version;
9. runs ``tone_bias_train ... 3 balance --auto-resume 1`` with an injected
   fault after the first epoch (phase ``elastic``) and checks that the
   supervisor resumed the folder to 3 epochs; runs ``tone_bias_predict``
   on the cli phase's folder (phase ``predict``) and holds it against the
   test CLI and a float32 CPU forward; runs the train CLI for an epoch
   under ``--profile`` (the Chrome trace must hold one preprocess-kernel
   device event per train step) and under ``--debug-nans`` (finite, one
   launch a step), then ``--debug-nans`` from a copy of the cli folder
   with one NaN weight (FloatingPointError at train step 1's log-probs),
   and the metadata, dataset and monitor CLIs (phase ``cli_tools``); saves a
   reference-shaped whole ``SkinCancerListModel`` at full width with
   ``torch.save``, imports its folder with ``import_reference``, holds the
   imported model's float32 forward on the card against the pickled
   module's on the CPU (2e-5 plus 1e-4 relative, no class change, and an
   import with every conv kernel's H and W swapped must fall outside
   that), scores the folder with ``tone_bias_test`` and
   trains it on for an epoch (phase ``migrate``); trains adamw, rmsprop,
   sgd and sgd with momentum through ``fit_arena`` and holds each one's
   first update on the card against the same update on the CPU (phase
   ``optimizers``);
10. trains resnet50 at 224² through the transfer trainer
   (``train_classifier``, phase ``transfer``) on that cohort's tone
   labels: 2 epochs, then 1 with ``freeze_backbone``; checks one
   preprocess launch per live step, the BatchNorm statistics, the frozen
   backbone bit for bit, the step's B=32 preprocess call against its
   plain version, the eval on the card against a float32 CPU forward and
   the reloaded ``session_model.msgpack``; trains the HAM CLI's default
   model, xception at full depth, the same way on the cohort's
   benign/malignant labels (phase ``xception``: the launches, all 80
   BatchNorm buffers, the eval against the CPU, the reload, a profile);
   and runs the ITA path (phase ``ita``): ``ita_pipeline`` on skin-coloured
   and cohort frames against the CPU, resnet50 on the ITA input through
   ``train_classifier`` with its identity-affine preprocess call against
   the plain version, and the modal-ITA classifiers;
   then the Keras-compatible families (phase ``families``):
   efficientnet_b0 at full depth for 1 epoch on the tone labels (the
   launches, the BatchNorm buffers, the eval against the CPU on 32 rows,
   the reload, a profile with the depthwise convs as their own group),
   one 8-step call each of resnet50_v2, vgg16, mobilenet_v2 and
   efficientnet_v2_b0 under the same checks, and every one of the 22
   registered variants built on the card with a 2-row bf16 eval forward
   held against its float32 forward;
   then the explain path (phase ``explain``): every method of the explain
   CLI's attribution step on the cli phase's folder at 224², B=6 (IG and
   GradientShap at 200 steps) with its time, IG's completeness, the
   deterministic methods on the card in float32 and bf16 against float32
   on the CPU, ``grad_cam_gap_head`` on resnet50, xception,
   efficientnet_b0 and mobilenet_v2 the same way, and the figures (an
   ImportError naming matplotlib where it is missing) and the analysis
   aggregate of the cli phase's results;
   then the serving path (phase ``serve``): the cli phase's folder behind
   the port's HTTP server (``InferenceSession``, ``DynamicBatcher``,
   ``make_http_server``) with the bucket ladder 1..64 timed, 32
   concurrent clients of raw ``/predict`` requests, a 64-row
   ``/predict_batch`` and a PNG ``/predict``, every answer held against a
   float32 CPU forward; ``/reload`` of a same-architecture folder and a
   refused (409) resnet50 one; and ``export_model`` of the flagship and
   resnet50 folders, each artifact served through ``from_artifact``.
   The serve path launches none of the port's kernels, and the phase
   checks that;
   then the int8 path (phase ``quantize``): that folder quantized with
   the JAX CLI's default calibration (256 train rows, max), its fidelity
   report against the float32 graph and the float session, the int8
   program on the card against the same tree on the CPU, the int8
   session behind ``make_http_server`` under 32 clients, both int8
   exports served through ``from_artifact``, and the captured graph and
   the int8 op list written as JSON lines (no kernel of the port
   launches here either); and HPO (phase ``hpo``): a wave of 4 stacked
   trials of the flagship skeleton padded to 256 at B=256, 224², bf16,
   for 3 steps with one preprocess launch a step, each trial's losses
   against a lone run of it, one wave of 8 trials at the reference's
   sweep protocol (its trials/hour), and the optuna CLI, sequential and
   as a wave, at a small size;
   streams the cohort through the train CLI with ``--streaming
   --stream-cache`` after the ``cli`` phase (phase ``streaming``: one
   launch a step, epoch 2 decoding nothing, the caches equal to the
   ``cli`` phase's arenas); and scale-out after ``hpo`` (phase
   ``parallel``): the train CLI in a world-size-1 NCCL group against a
   plain run (model file bit for bit), DP and TP over two gloo ranks
   sharing the card against one process, a mesh session and
   ``run_wave_study`` over ``[cuda:0, cuda:0]`` against one device, each
   phase's seconds on one line;
11. lists every TPU kernel of the JAX package with its port status, then
   the ``{"kernels": [...]}`` line (the preprocess kernel's launches are
   the main path's: the JPEG cohort's train CLI and tone classifier, the
   train CLI, the streamed run, both feeds, the
   elastic run, the cli_tools and migrate runs, the optimizers' fits,
   the transfer runs, the xception run, the ITA run, the family runs,
   the hpo phase and the parallel phase's runs and steps; the BatchNorm
   kernels' rows carry their calls in the two ResNet-50 transfer runs,
   beside those runs' train and eval forwards, and their times at the
   three shapes) and the card's name and power limit;
12. ends with ``{"ok": true, "device": {...}}`` on its last line.

Each phase prints one JSON line (the ``pconv0`` phase also the rig's own
lines). Any failure raises and exits non-zero. It imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
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
    the train step's shapes (gathering rows of an arena, and, as the
    host-batch feed calls it, on an uploaded batch without rows), and the
    tail at a 1024 crop (the sums launch)."""
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
        b = offsets.shape[0]
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
        evs = device_kernels(lambda: fused_preprocess_planar(*args, **kw))
        per_call = sum(ev.count for ev in evs)
        # without rows, the wrapper's arange is one more device kernel
        kernels_per_call = sum(
            ev.count for ev in evs
            if _kernel_group(ev.key).startswith("preprocess"))
        plan = band_plan(t, 3, space_to_depth=v["s2d"],
                         tail=bool(v["tail"]))
        if kernels_per_call != 1 + plan.sums_launch \
                or per_call != kernels_per_call + (rows is None):
            raise AssertionError(f"{name}: {kernels_per_call} preprocess "
                                 f"kernels of {per_call} device kernels a "
                                 f"call, the plan needs "
                                 f"{1 + plan.sums_launch}")
        launches = fused_preprocess_planar.launches - launches_before
        elt = got.element_size()
        n_px = b * 3 * t * t
        # the function's bytes: the crop read once, the output written once
        moved = n_px + n_px * elt \
            + (0 if rows is None else rows.numel() * 4) \
            + offsets.numel() * 4 \
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
            "preprocess_kernels_per_call": kernels_per_call,
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
    # the host-batch feed's form: an uploaded batch, no rows
    batch_pixels = arena[rows.long()].contiguous()
    lines.append(check("tail_bf16_rows_none", variants["tail_bf16"],
                       batch_pixels, None, offsets, flips, tail_args, crop))
    del arena, batch_pixels
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


#: the BatchNorm shapes the kernels line reports (ResNet-50 at B=256,
#: 224²): name, channels, side, whether the residual epilogue is asked
BN_SHAPES = (("stem", 64, 112, False), ("stage1", 256, 56, True),
             ("stage4", 2048, 7, True))
BN_BATCH = 256
BN_FORMS = ("train", "backward", "eval")


def _bn_layers(torch) -> dict:
    """{(C, H*W, residual): count} of ResNet-50's 53 BatchNorm calls at
    224², from a B=1 forward on the card."""
    from skin_image_analysis_tpu_torch.models import resnet

    model = resnet.resnet50(num_classes=7, device="cuda")
    model.reset_parameters(None)
    layers = {}

    def record(m, args, kwargs):
        x = args[0]
        key = (x.shape[1], x.shape[2] * x.shape[3],
               kwargs.get("residual") is not None)
        layers[key] = layers.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(record, with_kwargs=True)
             for m in model.modules() if isinstance(m, resnet.BatchNorm)]
    with torch.no_grad():
        model(torch.zeros(1, 224, 224, 3, device="cuda"))
    for h in hooks:
        h.remove()
    if sum(layers.values()) != 53:
        raise AssertionError(f"resnet50 ran {sum(layers.values())} "
                             f"BatchNorms, not 53")
    return layers


def _bn_against_plain(torch, bk, name, x, p, r, dy) -> dict:
    """The three forms on (x, p, r, dy), with the ReLU epilogue (and the
    residual where ``r`` is given), held to the plain versions by the
    rules of ``tests/test_torch_cuda.py``'s
    ``test_batchnorm_kernel_against_plain``: the mean, dgamma and dbeta
    within 2e-5 of the sum of their terms' magnitudes (float32 sums in
    another order), rstd and the running variance within 2e-5 of
    themselves and the running mean within 1e-6, each against
    ``batchnorm_ref`` on clones of the same running buffers; the varg
    flag 1 on every channel; y bit for bit given the kernel's statistics;
    dx within a bf16 ulp and 1e-4 of its largest; the residual's gradient
    and the eval form bit for bit. Raises on any miss; returns each
    form's largest absolute error."""
    w, b, rm0, rv0 = p
    rm, rv, rm_p, rv_p = rm0.clone(), rv0.clone(), rm0.clone(), rv0.clone()
    res = r is not None
    y, mean, rstd, varg = bk.batchnorm_train_forward(
        x, w, b, rm, rv, momentum=0.99, eps=1e-5, relu=True, residual=r)
    _, mean_p, rstd_p, raw_p = bk.batchnorm_ref(
        x, w, b, rm_p, rv_p, train=True, momentum=0.99, eps=1e-5)
    xf = x.float()
    y_p = bk.batchnorm_apply_ref(xf, w, b, mean, rstd, x.dtype, True, r)
    dx, dw, db, dres = bk.batchnorm_backward(
        dy, x, y if res else None, w, b, mean, rstd, varg, relu=True,
        residual=res)
    dx_p, dw_p, db_p, dres_p = bk.batchnorm_backward_ref(
        dy, x, y, w, mean, rstd, varg, relu=True, residual=res)
    ye = bk.batchnorm_eval_forward(x, w, b, rm, rv, eps=1e-5, relu=True,
                                   residual=r)
    ye_p = bk.batchnorm_ref(x, w, b, rm, rv, train=False, momentum=0.99,
                            eps=1e-5, relu=True, residual=r)[0]
    g = torch.where(y <= 0, 0.0, dy.float())
    xhat = (xf - mean[:, None, None]) * rstd[:, None, None]
    live = (raw_p >= 0) & (rstd_p < 100)  # not a (near-)constant channel

    def excess(got, want, bound):
        """The largest amount by which |got - want| exceeds ``bound``."""
        return float(((got.float() - want.float()).abs() - bound).max())

    def sums(terms):
        return 2e-5 * terms + 1e-6

    over = {
        "mean": excess(mean, mean_p, sums(xf.abs().mean(dim=(0, 2, 3)))),
        "rstd": excess(rstd[live], rstd_p[live], 2e-5 * rstd_p[live]),
        "varg": float((varg[live] != 1).sum()),
        "running_mean": excess(rm, rm_p, 1e-7 + 1e-6 * rm_p.abs()),
        "running_var": excess(rv[live], rv_p[live],
                              1e-7 + 2e-5 * rv_p[live].abs()),
        "y": excess(y, y_p, 0.0),
        "dx": excess(dx, dx_p, dx_p.float().abs() * 2 ** -7
                     + 1e-4 * float(dx_p.abs().max())),
        "dbeta": excess(db, db_p, sums(g.abs().sum(dim=(0, 2, 3)))),
        "dgamma": excess(dw, dw_p, sums((g * xhat).abs()
                                        .sum(dim=(0, 2, 3)))),
        "dresidual": excess(dres, dres_p, 0.0) if res else 0.0,
        "eval": excess(ye, ye_p, 0.0),
    }
    missed = {k: v for k, v in over.items() if not v <= 0}
    if missed or int(live.sum()) == 0:
        raise AssertionError(f"batchnorm {name}: over its tolerance by "
                             f"{missed}, {int(live.sum())} live channels")
    return {"train": float((y.float() - y_p.float()).abs().max()),
            "backward": float((dx.float() - dx_p.float()).abs().max()),
            "eval": float((ye.float() - ye_p.float()).abs().max())}


def phase_batchnorm(torch) -> list[dict]:
    """The fused BatchNorm kernels at ResNet-50's stem (ReLU epilogue),
    stage-1 and stage-4 shapes (residual and ReLU), B=256, bf16, NCHW as
    the train step feeds them: each form held to its plain version
    (``_bn_against_plain``: the statistics, running averages, dgamma and
    dbeta too) and timed beside the plain version, its byte bound (each
    tensor once) and the two-pass design's floor (x read twice in the
    train forward, x and dy in the backward). Then all 53 layers, timed
    and summed: the whole step's train forward, backward and eval beside
    the summed bounds."""
    from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel \
        as bk
    from skin_image_analysis_tpu_torch.tools.perf_attrib import (
        cuda_ms,
        l2_flusher,
    )

    dev = torch.device("cuda")
    rate = mem_rate(torch.cuda.get_device_name(0))
    flush = l2_flusher(dev)
    g = torch.Generator(device=dev).manual_seed(5)

    def tensors(c, side, res):
        shape = (BN_BATCH, c, side, side)
        x = (torch.randn(shape, device=dev, generator=g) * 1.5 + 0.3).to(
            torch.bfloat16)
        r = torch.randn(shape, device=dev, generator=g).to(
            torch.bfloat16) if res else None
        dy = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
        p = (torch.rand(c, device=dev, generator=g) + 0.5,
             torch.randn(c, device=dev, generator=g) * 0.2,
             torch.randn(c, device=dev, generator=g) * 0.1,
             torch.rand(c, device=dev, generator=g) + 0.5)
        return x, r, dy, p

    def calls(x, r, dy, p):
        """{form: (kernel call, plain call)} on these tensors."""
        w, b, rm, rv = p
        kw = dict(relu=True, residual=r)
        y, mean, rstd, varg = bk.batchnorm_train_forward(
            x, w, b, rm.clone(), rv.clone(), momentum=0.99, eps=1e-5, **kw)
        bw = dict(relu=True, residual=r is not None)
        return {
            "train": (lambda: bk.batchnorm_train_forward(
                x, w, b, rm, rv, momentum=0.99, eps=1e-5, **kw),
                lambda: bk.batchnorm_ref(
                    x, w, b, rm.clone(), rv.clone(), train=True,
                    momentum=0.99, eps=1e-5, **kw)),
            "backward": (lambda: bk.batchnorm_backward(
                dy, x, y if r is not None else None, w, b, mean, rstd,
                varg, **bw),
                lambda: bk.batchnorm_backward_ref(
                    dy, x, y, w, mean, rstd, varg, **bw)),
            "eval": (lambda: bk.batchnorm_eval_forward(
                x, w, b, rm, rv, eps=1e-5, **kw),
                lambda: bk.batchnorm_ref(
                    x, w, b, rm, rv, train=False, momentum=0.99, eps=1e-5,
                    **kw)),
        }

    def ms_of(nbytes):
        return nbytes / rate * 1e3

    lines = []
    for name, c, side, res in BN_SHAPES:
        x, r, dy, p = tensors(c, side, res)
        errs = _bn_against_plain(torch, bk, name, x, p, r, dy)
        fns = calls(x, r, dy, p)
        for form in BN_FORMS:
            kernel, plain = fns[form]
            ms = cuda_ms(kernel, 20, flush)
            plain_ms = cuda_ms(plain, 5, flush)
            hw = side * side
            one = bk.bn_bytes(BN_BATCH, c, hw, form=form, residual=res,
                              relu=True)
            two = bk.bn_bytes(BN_BATCH, c, hw, form=form, residual=res,
                              relu=True, passes=2)
            lines.append({
                "phase": "batchnorm", "shape": name, "form": form,
                "n": BN_BATCH, "c": c, "hw": hw, "residual": res,
                "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
                "bytes": one, "bound_ms": ms_of(one), "bound_by": "bytes",
                "floor_ms": ms_of(two),
                "bound_pct": 100 * ms_of(one) / ms,
                "floor_pct": 100 * ms_of(two) / ms,
                "max_abs_err": errs[form],
                "plan": bk.bn_plan(BN_BATCH, c, hw, 2)._asdict()})
            emit(lines[-1])
        del x, r, dy, fns

    layers = _bn_layers(torch)
    total = {form: {"ms": 0.0, "bound_ms": 0.0, "floor_ms": 0.0}
             for form in BN_FORMS}
    for (c, hw, res), count in sorted(layers.items()):
        side = int(round(hw ** 0.5))
        fns = calls(*tensors(c, side, res))
        for form in BN_FORMS:
            ms = cuda_ms(fns[form][0], 10, flush)
            total[form]["ms"] += count * ms
            total[form]["bound_ms"] += count * ms_of(bk.bn_bytes(
                BN_BATCH, c, hw, form=form, residual=res, relu=True))
            total[form]["floor_ms"] += count * ms_of(bk.bn_bytes(
                BN_BATCH, c, hw, form=form, residual=res, relu=True,
                passes=2))
            emit({"phase": "batchnorm_layer", "c": c, "hw": hw,
                  "residual": res, "count": count, "form": form, "ms": ms})
        del fns
    for form, t in total.items():
        t.update(bound_pct=100 * t["bound_ms"] / t["ms"],
                 floor_pct=100 * t["floor_ms"] / t["ms"])
    line = {"phase": "batchnorm_step", "n": BN_BATCH, "layers": 53,
            "distinct": len(layers), **total}
    emit(line)
    lines.append(line)
    return lines


def _bn_counted(torch, name: str, run, backward: bool):
    """``run()`` with the BatchNorm kernels' launch counts set to 0 just
    before it and ``ResNet.features``' train and eval calls counted; then
    checks that every BatchNorm call of the run went through the kernels:
    53 train forwards for each train call (and 53 backwards, or none with
    the backbone frozen), 53 eval forwards for each eval call. Returns
    ``(run's result, the counts)``."""
    from skin_image_analysis_tpu_torch.models import resnet
    from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel \
        as bk

    entries = {"train_forward": bk.batchnorm_train_forward,
               "backward": bk.batchnorm_backward,
               "eval_forward": bk.batchnorm_eval_forward}
    calls = {"train_calls": 0, "eval_calls": 0}

    def count(features):
        def call(self, x, train=False, *a, **kw):
            calls["train_calls" if train else "eval_calls"] += 1
            return features(self, x, train, *a, **kw)
        return call

    for fn in entries.values():
        fn.launches = 0
    with _Patch(resnet.ResNet, "features", count):
        out = run()
    torch.cuda.synchronize()
    got = {k: fn.launches for k, fn in entries.items()} | calls
    want = {"train_forward": 53 * calls["train_calls"],
            "backward": 53 * calls["train_calls"] if backward else 0,
            "eval_forward": 53 * calls["eval_calls"]}
    if (any(got[k] != v for k, v in want.items())
            or not calls["train_calls"] or not calls["eval_calls"]):
        raise AssertionError(f"{name}: BatchNorm kernel calls {got}, "
                             f"not {want}")
    return out, got


def _bn_kernel_rows(bn_lines: list[dict], launches: dict) -> list[dict]:
    """The kernels line's rows of the BatchNorm kernels, which replace no
    TPU kernel: each form's calls in the ResNet-50 transfer runs (the main
    path's: ``launches``, ``phase_transfer``'s fine-tune and frozen counts
    beside their train and eval forwards, and 0 in the flagship's fit),
    its times at the three shapes, and the stem's in the row's own
    fields."""
    rows = []
    for form, key in zip(BN_FORMS, ("train_forward", "backward",
                                    "eval_forward")):
        at = {ln["shape"]: {k: ln[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "floor_ms")}
              for ln in bn_lines if ln.get("form") == form}
        rows.append({
            "name": f"batchnorm_{key}", "route": "cuda",
            "source": "skin_image_analysis_tpu_torch/csrc/"
                      "batchnorm_kernel.cu",
            "replaces": None,
            "launches": {run: {key: n[key], "train_calls": n["train_calls"],
                               "eval_calls": n["eval_calls"]}
                         for run, n in launches.items()} | {"flagship": 0},
            "max_abs_err": max(ln["max_abs_err"] for ln in bn_lines
                               if ln.get("form") == form),
            **at["stem"], "bound_by": "bytes", "library_ms": None,
            "shapes": at})
    return rows


#: Xception's depthwise convs at 299² (the cell's input), B=256: (channels,
#: side) and convs of each shape, 34 in all
DW_SHAPES = {(64, 147): 1, (128, 147): 1, (128, 74): 1, (256, 74): 1,
             (256, 37): 1, (728, 37): 1, (728, 19): 26, (1024, 10): 1,
             (1536, 10): 1}
DW_BATCH = 256


def _dw_against_plain(torch, dk, x, dy, w) -> dict:
    """The depthwise kernels on (x, dy, w) held to the plain versions by
    ``tests/test_torch_depthwise_kernel.py``'s rules: y and dx within one
    bf16 ulp of the plain versions plus float32 round-off of their terms'
    magnitudes (2e-6 of them: the sums run in another order before the one
    rounding); dW within 1e-5 of its products' magnitudes of the float64
    sum; dW twice bit for bit. Raises on any miss; returns the largest
    absolute errors."""
    import torch.nn.functional as F

    c = x.shape[1]
    wr = w.to(x.dtype).double()
    y = dk.depthwise_forward(x, w)
    dx, dw = dk.depthwise_backward(dy, x, w)
    _, dw2 = dk.depthwise_backward(dy, x, w)
    y_p = dk.depthwise3x3_ref(x, w)
    dx_p, _ = dk.depthwise3x3_backward_ref(dy, x, w)

    def excess(got, want, terms):
        return float(((got.double() - want.double()).abs()
                      - bf16_tol(want).double() - 2e-6 * terms).max())

    over = {"y": excess(y, y_p, F.conv2d(x.double().abs(), wr.abs(),
                                         padding=1, groups=c))}
    err = {"y": float((y.float() - y_p.float()).abs().max())}
    del y, y_p
    over["dx"] = excess(dx, dx_p, F.conv2d(dy.double().abs(),
                                           wr.abs().flip(2, 3), padding=1,
                                           groups=c))
    err["dx"] = float((dx.float() - dx_p.float()).abs().max())
    del dx, dx_p
    _, dw64 = dk.depthwise3x3_backward_ref(dy.double(), x.double(), wr)
    terms = torch.nn.grad.conv2d_weight(x.double().abs(), w.shape,
                                        dy.double().abs(), padding=1,
                                        groups=c)
    over["dw"] = float(((dw.double() - dw64).abs() - 1e-5 * terms
                        - 1e-7).max())
    err["dw"] = float((dw.double() - dw64).abs().max())
    missed = {k: v for k, v in over.items() if not v <= 0}
    if missed or not torch.equal(dw, dw2):
        raise AssertionError(f"depthwise {tuple(x.shape)}: over its "
                             f"tolerance by {missed}, dW twice bit for bit "
                             f"{torch.equal(dw, dw2)}")
    return err


def phase_depthwise(torch) -> list[dict]:
    """The depthwise 3x3 kernels at each of Xception's conv shapes at 299²,
    B=256, bf16: held to the plain versions (``_dw_against_plain``), then
    each direction timed beside its bound (each tensor once: x read and y
    written forward, x and dy read and dx written backward, over the card's
    memory rate), the benchmark's count of the same bytes (which reads dy
    twice in a train step: for dx and for dW), the plain version and ATen's
    ``conv_depthwise2d`` kernels, the path the kernels replace, as
    ``library_ms``. Then the 34 convs summed: a train step's forward and
    backward."""
    import torch.nn.functional as F

    from skin_image_analysis_tpu_torch.ops.kernels import depthwise_kernel \
        as dk
    from skin_image_analysis_tpu_torch.tools.perf_attrib import (
        cuda_ms,
        l2_flusher,
    )

    dev = torch.device("cuda")
    rate = mem_rate(torch.cuda.get_device_name(0))
    flush = l2_flusher(dev)
    g = torch.Generator(device=dev).manual_seed(25)
    lines = []
    step = {form: {"ms": 0.0, "bound_ms": 0.0, "bench_bound_ms": 0.0,
                   "library_ms": 0.0} for form in ("forward", "backward")}
    for (c, side), count in DW_SHAPES.items():
        shape = (DW_BATCH, c, side, side)
        x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
        dy = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
        w = torch.randn((c, 1, 3, 3), device=dev, generator=g) * 0.3
        errs = _dw_against_plain(torch, dk, x, dy, w)
        wb = w.to(torch.bfloat16)
        calls = {
            "forward": (lambda: dk.depthwise_forward(x, w),
                        lambda: dk.depthwise3x3_ref(x, w),
                        lambda: F.conv2d(x, wb, padding=1, groups=c)),
            "backward": (lambda: dk.depthwise_backward(dy, x, w),
                         lambda: dk.depthwise3x3_backward_ref(dy, x, w),
                         lambda: torch.ops.aten.convolution_backward(
                             dy, x, wb, None, [1, 1], [1, 1], [1, 1], False,
                             [0, 0], c, [True, True, False])),
        }
        for form, (kernel, plain, library) in calls.items():
            ms = cuda_ms(kernel, 20, flush)
            nbytes = dk.depthwise_bytes(DW_BATCH, c, side, side, form=form)
            # the benchmark reads dy twice a train step (dx's and dW's)
            bench = nbytes * 4 // 3 if form == "backward" else nbytes
            line = {"phase": "depthwise", "c": c, "side": side,
                    "convs": count, "form": form, "n": DW_BATCH,
                    "dtype": "bfloat16", "ms": ms,
                    "plain_ms": cuda_ms(plain, 5, flush),
                    "library_ms": cuda_ms(library, 5, flush),
                    "bytes": nbytes, "bound_ms": nbytes / rate * 1e3,
                    "bench_bound_ms": bench / rate * 1e3,
                    "bound_by": "bytes",
                    "max_abs_err": errs["y" if form == "forward" else "dx"],
                    "dw_max_abs_err": errs["dw"],
                    "plan": dk.depthwise_plan(
                        DW_BATCH, c, side, side, 2,
                        1 if form == "forward" else 2)._asdict()}
            line["bound_pct"] = 100 * line["bound_ms"] / ms
            for k in step[form]:
                step[form][k] += count * line[k]
            emit(line)
            lines.append(line)
        del x, dy, calls
    for t in step.values():
        t["bound_pct"] = 100 * t["bound_ms"] / t["ms"]
        t["bench_bound_pct"] = 100 * t["bench_bound_ms"] / t["ms"]
    line = {"phase": "depthwise_step", "n": DW_BATCH, "convs": 34, **step}
    emit(line)
    lines.append(line)
    return lines


def _dw_kernel_rows(dw_lines: list[dict], launches: dict) -> list[dict]:
    """The kernels line's rows of the depthwise kernels, which replace no
    TPU kernel: each direction's calls in the xception phase's run
    (``launches``), its 34-conv train step and each of its shapes."""
    step = dw_lines[-1]
    rows = []
    for form, name in (("forward", "depthwise3x3_fwd"),
                       ("backward", "depthwise3x3_bwd + finalize")):
        shapes = {f"{ln['c']}x{ln['side']}": {
            k: ln[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
            for ln in dw_lines[:-1] if ln["form"] == form}
        rows.append({
            "name": name, "route": "cuda",
            "source": "skin_image_analysis_tpu_torch/csrc/"
                      "depthwise_kernel.cu",
            "replaces": None, "launches": {"xception": launches[form]},
            "max_abs_err": max(ln["max_abs_err"] for ln in dw_lines[:-1]
                               if ln["form"] == form),
            **{k: step[form][k] for k in ("ms", "bound_ms", "library_ms")},
            "plain_ms": sum(ln["convs"] * ln["plain_ms"]
                            for ln in dw_lines[:-1] if ln["form"] == form),
            "bound_by": "bytes", "shapes": shapes})
    return rows


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


def _check_fit(result, launches: int, cfg, n_train: int, n_test: int,
               kernel: bool = True):
    """The checks every fit_arena run here must pass (one preprocess
    launch per live train step, or none without ``kernel``); returns
    (losses, live train steps)."""
    import numpy as np

    from skin_image_analysis_tpu_torch.train.loop import RECORD_KEYS

    losses = np.concatenate(result.step_losses)
    counts = np.concatenate(result.step_counts)
    steps = int((counts > 0).sum())
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite train losses: {losses}")
    if launches != (steps if kernel else 0) \
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


def phase_preprocess_switch(torch) -> dict:
    """``data.pallas_preprocess`` through ``fit_arena`` at full width, one
    epoch of K steps each: "on" without augmentation on 224² frames (the
    kernel for every train call: its centre crop is the frame; one launch
    a step), and "off" with augmentation on 256² frames (the plain
    preprocess on the card: no launch). Then the "on" train call's
    kernel output on one batch held against its plain version on the same
    inputs (the same call on the CPU: the wrapper's plain twin) and
    against the "off" path's plain resize, each to one bf16 ulp."""
    from skin_image_analysis_tpu_torch import config as cfg_lib
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.train import loop

    n_train = BATCH * K
    lines = {}
    for pallas, augment, side in (("on", False, CROP), ("off", True, SIZE)):
        cfg = cfg_lib.TrainConfig(
            epochs=1, seed=0,
            data=cfg_lib.DataConfig(image_size=CROP, canonical_size=side,
                                    batch_size=BATCH, augment=augment,
                                    steps_per_dispatch=K,
                                    pallas_preprocess=pallas),
            model=cfg_lib.ModelConfig(compute_dtype="bfloat16",
                                      image_size=CROP),
            optim=cfg_lib.OptimConfig(learning_rate=1e-5))
        result, launches, wall, train_arena, _ = _fit(
            torch, cfg, n_train, TEST_ROWS, seed=3, side=side)
        losses, steps = _check_fit(result, launches, cfg, n_train,
                                   TEST_ROWS, kernel=pallas == "on")
        lines[pallas] = {"augment": augment, "frame": side, "steps": steps,
                         "launches": launches, "wall_s": wall,
                         "loss_first": float(losses[0]),
                         "loss_last": float(losses[-1]),
                         "accuracy": result.records[-1]["accuracy"]}
        if pallas == "on":
            on_pre = loop._preprocess_fns(cfg, cfg.model, None)[0]
            on_arena = train_arena
        del result
    rows = torch.arange(BATCH, dtype=torch.int32, device="cuda")
    got = on_pre(on_arena, None, rows=rows)
    plain = on_pre(on_arena.cpu(), None, rows=rows.cpu())
    off = make_preprocess_fn(CROP, train=True, layout="planar",
                             pallas="off")(on_arena[rows.long()], None)
    held = {}
    for name, want in (("plain_twin", plain), ("off_path", off.cpu())):
        want = want.to(torch.bfloat16).float()
        diff = (got.float().cpu() - want).abs()
        if got.shape != want.shape or got.dtype != torch.bfloat16 \
                or not (diff <= bf16_tol(want)).all():
            raise AssertionError(f"pallas on: the kernel's output is "
                                 f"{float(diff.max())} from its {name}")
        held[name] = float(diff.max())
    del on_arena, got, plain, off
    torch.cuda.empty_cache()
    line = {"phase": "preprocess_switch", "batch": BATCH, "k": K,
            "runs": lines, "on_call_max_abs_err": held,
            "held": "1 bf16 ulp",
            "launches": lines["on"]["launches"] + lines["off"]["launches"]}
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
    if "preprocess" in low or "crop_sums" in low:
        return "preprocess kernel (port)"
    if "depthwise" in low:
        return "depthwise convolution"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout conversion (cuDNN)"
    if any(w in low for w in ("cudnn", "conv", "fprop", "dgrad", "wgrad")):
        return "convolution (cuDNN)"
    if any(w in low for w in ("gemm", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


def _profile(torch, call, steps: int, batch: int, watch=()) -> dict:
    """Device time by kernel group, kernel and the operator that launched
    it, over one ``call()`` (after a warm one), from torch.profiler,
    against the call's wall time; ``kernels_named`` counts the launches of
    the kernels whose names hold each string of ``watch``."""
    from torch.profiler import ProfilerActivity, profile

    from skin_image_analysis_tpu_torch.utils.profiling import SPAN_PREFIX

    call()
    torch.cuda.synchronize()
    # a session can lose all of its device records (``device_kernels``):
    # profile the call again, at most 5 times, until one reports any
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if any(ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.key.startswith(SPAN_PREFIX)
               for ev in prof.key_averages()):
            break
    # device kernels, and the host operators that launched them (an
    # operator's self device time is that of the kernels it launched)
    kernels, ops, pre_launches, launches = {}, {}, 0, 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        # the program's spans are ranges, neither kernels nor operators
        if us <= 0 or ev.key.startswith(SPAN_PREFIX):
            continue
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        table = kernels if on_device else ops
        table[ev.key] = table.get(ev.key, 0.0) + us / 1e3
        if on_device:
            launches += ev.count
            if _kernel_group(ev.key).startswith("preprocess"):
                pre_launches += ev.count
    device_ms = sum(kernels.values())
    groups = {}
    for name, ms in kernels.items():
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    # the program's spans: calls, and the device time of the kernels
    # launched inside them (a range's host event holds its children's)
    spans = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CPU
                and ev.name.startswith(SPAN_PREFIX)):
            span = spans.setdefault(ev.name, {"calls": 0, "device_ms": 0.0})
            span["calls"] += 1
            span["device_ms"] += ev.device_time_total / 1e3

    def top(table):
        return [[name[:90], ms] for name, ms
                in sorted(table.items(), key=lambda kv: -kv[1])[:12]]

    return {
        "steps": steps, "batch": batch,
        "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms,
        "step_ms": wall_ms / steps,
        "img_per_s": steps * batch / (wall_ms / 1e3),
        "device_kernels_per_step": launches / steps,
        "by_group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "preprocess_launches_per_step": pre_launches / steps,
        "top_kernels_ms": top(kernels),
        "top_ops_ms": top(ops),
        "spans": spans,
        "kernels_named": {w: sum(ev.count for ev in prof.key_averages()
                                 if ev.device_type
                                 == torch.autograd.DeviceType.CUDA
                                 and w in ev.key) for w in watch},
    }


def phase_profile(torch, state, arena) -> dict:
    """Device time by kernel and by the operator that launched it, over one
    steady k-step call of the train step, from torch.profiler, against the
    call's wall time."""
    import numpy as np

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
    line = {"phase": "profile", **_profile(
        torch, lambda: multi_train_step(state, arena, idx, labels, valid,
                                        None, pre), K, BATCH)}
    emit(line)
    return line


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


def _cohort_rows(rng, n: int) -> list[dict]:
    """``n`` ISIC metadata rows drawn from ``rng``: half malignant, half
    light (Fitzpatrick I/II), every 16th row without a type."""
    fitz = ("I", "II", "III", "IV", "V", "VI")
    rows = []
    for i in range(n):
        light = rng.random() < 0.5
        rows.append({
            "isic_id": f"ISIC_{i:07d}", "attribution": "chip_smoke",
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
    return rows


def _write_metadata(root: str, rows: list[dict]) -> None:
    import csv

    with open(os.path.join(root, "metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)


def _write_cohort(root: str, n: int, seed: int):
    """metadata.csv and one DICOM per row; returns {isic_id: frame}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    rows = _cohort_rows(rng, n)
    ids = [row["isic_id"] for row in rows]
    for isic_id, frame in zip(ids, frames):
        with open(os.path.join(root, f"{isic_id}.dcm"), "wb") as f:
            f.write(_dicom_rgb(frame))
    _write_metadata(root, rows)
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


def _folder_records(folder: str) -> list[dict]:
    """The epoch records of every results file of a folder, in order."""
    from skin_image_analysis_tpu_torch.utils import jsonl

    names = sorted(n for n in os.listdir(folder)
                   if n.endswith(".json") and n[0].isdigit())
    return [r for n in names
            for r in jsonl.read_records(os.path.join(folder, n))]


def _check_records(records, n_test: int, epochs: int) -> None:
    import numpy as np

    from skin_image_analysis_tpu_torch.train.loop import RECORD_KEYS

    if len(records) != epochs:
        raise AssertionError(f"{len(records)} records for {epochs} epochs")
    for rec in records:
        missing = set(RECORD_KEYS) - set(rec)
        if missing or rec["total"] != n_test \
                or not np.isfinite(rec["avg_batch_loss"]):
            raise AssertionError(f"record lacks {sorted(missing)} or covers "
                                 f"{rec['total']} of {n_test} rows")


def _cpu_reference(torch, folder: str, root224: str, test_ids, card,
                   atol: float = 5e-3) -> tuple[int, int, int]:
    """The folder's model in float32 on the CPU over the first test rows'
    224 crops against ``card``, the classes predicted on the card by test
    row: (rows, decided rows, class changes); any change of class where
    the reference's two log-probabilities differ by more than ``atol``
    raises."""
    import dataclasses

    from skin_image_analysis_tpu_torch.data.dataset import LesionTable
    from skin_image_analysis_tpu_torch.data.ingest import read_csv
    from skin_image_analysis_tpu_torch.data.loader import HostImageStore
    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt
    from skin_image_analysis_tpu_torch.train import loop

    n_ref = min(256, len(test_ids))
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
    flipped = int((want.argmax(1).numpy() != card[:n_ref])[decided].sum())
    if flipped or decided.sum() < min(64, n_ref):
        raise AssertionError(f"{flipped} of {int(decided.sum())} decided "
                             f"rows differ from the CPU float32 forward")
    return n_ref, int(decided.sum()), flipped


def phase_cli(torch, work: str, root: str, frames: dict,
              write_s: float) -> tuple[dict, dict]:
    """The flagship CLIs end to end on the card, in the working directory
    ``work`` over the cohort at ``root``: ``tone_bias_train <root> 2
    balance --augment --batch-size 256 --steps-per-dispatch 4 --seed 0``
    (full width, 224 crops of 256 frames, bf16), the same CLI for 1 epoch
    on the folder it made (a resume), then ``tone_bias_test`` on it.
    Checks the folder, finite losses, one preprocess-kernel launch per
    train step, the resume's state restored bit for bit, the test record
    over every test row, and the test CLI's predictions against a float32
    CPU forward of the same checkpoint. Returns the line and what the
    predict phase reads: the folder, the test rows' 224 crops and the
    test CLI's predictions."""
    import contextlib
    import io

    import numpy as np

    from skin_image_analysis_tpu_torch.cli import tone_bias_test
    from skin_image_analysis_tpu_torch.cli import tone_bias_train
    from skin_image_analysis_tpu_torch.data.loader import HostImageStore
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt
    from skin_image_analysis_tpu_torch.train import evaluate, loop

    root224 = os.path.join(work, "c224")
    os.makedirs(root224)
    cwd = os.getcwd()
    log = io.StringIO()
    try:
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

        decoded = []  # the first run's host arenas, for phase streaming

        def keep_arenas(decode):
            def call(*a, **kw):
                out = decode(*a, **kw)
                if not decoded:
                    decoded.append([store.images for store in out[0]])
                return out
            return call

        def train(argv):
            fused_preprocess_planar.launches = 0
            losses.clear()
            spent.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with _Patch(loop, "multi_train_step", record_losses), \
                    _Patch(loop, "_decode_arenas",
                           lambda f: keep_arenas(timed("decode")(f))), \
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

        args = ["--augment", "--batch-size", str(BATCH), "--image-size",
                str(CROP), "--steps-per-dispatch", str(K), "--seed", "0"]
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
        records = _folder_records(folder)
        _check_records(records, len(test_ids), 2)
        if loop.completed_epochs(folder) != 2:
            raise AssertionError(f"progress {loop.completed_epochs(folder)}")

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
                and snap["optimizer"] == saved["optimizer"]
                and snap["opt_count"] == saved["opt_count"]
                and torch.equal(snap["generator"], saved["generator"])
                and all(torch.equal(snap["model"][k], v)
                        for k, v in saved["model"].items())
                and all(torch.equal(a, b) for a, b in zip(
                    snap["opt_state"]["mu"] + snap["opt_state"]["nu"],
                    saved["opt_state"]["mu"] + saved["opt_state"]["nu"])))
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
        card = np.empty(len(test_ids), np.int64)
        card[pred["row_id"]] = pred["pred"]
        n_ref, decided, flipped = _cpu_reference(torch, folder, root224,
                                                 test_ids, card)
    except BaseException:
        print(log.getvalue()[-4000:], file=sys.stderr)
        raise
    finally:
        os.chdir(cwd)
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
        "reference_rows": n_ref, "decided_rows": decided,
        "class_changes": flipped, "card": nvidia_smi_line(),
    }
    emit(line)
    return line, {"work": work, "folder": folder, "root224": root224,
                  "test_ids": test_ids, "test_predictions": pred,
                  "arenas": dict(zip(("train", "test"), decoded[0]))}


STREAM_CHUNK = 1024


def phase_streaming(torch, work: str, root: str, ctx: dict) -> dict:
    """Streaming ingest on the card (``data.streaming``) through the train
    CLI: ``tone_bias_train <root> 2 balance --augment --batch-size 256
    --streaming --stream-cache --chunk-size 1024`` at full width, in its
    own directory. Each chunk crosses to the card once, and the
    preprocess kernel gathers every step's rows from it.

    Checks: exactly one preprocess launch a step (each chunk's remainder
    dropped); epoch 1 decodes every frame of both splits and epoch 2 none
    (the cache serves them); the caches' frames equal the cli phase's
    decoded arenas (the same splits) byte for byte once transposed; no bad
    rows; finite losses; each record's ``total`` is the test split's
    size. Reports each epoch's seconds and img/s, epoch 1's decode
    seconds and the cache's MB."""
    import contextlib
    import io
    import re

    import numpy as np

    from skin_image_analysis_tpu_torch.cli import tone_bias_train
    from skin_image_analysis_tpu_torch.data.streaming import cache_file
    from skin_image_analysis_tpu_torch.train import loop

    arenas = ctx.pop("arenas")
    here = os.path.join(work, "streaming")
    os.makedirs(here)
    cwd = os.getcwd()
    log = io.StringIO()
    args = [root, "2", "balance", "--augment", "--batch-size", str(BATCH),
            "--image-size", str(CROP), "--seed", "0", "--streaming",
            "--stream-cache", "--chunk-size", str(STREAM_CHUNK)]
    try:
        os.chdir(here)
        with contextlib.redirect_stdout(log):
            (rc, launches, losses, steps, wall) = _recorded_run(
                torch, lambda: tone_bias_train.main(args))
    except BaseException:
        print(log.getvalue()[-4000:], file=sys.stderr)
        raise
    finally:
        os.chdir(cwd)
    text = log.getvalue()
    folder = text.rsplit("Experiment folder: ", 1)[1].strip()
    folder = os.path.join(here, folder)
    n_train = len(_read_split(folder, loop.TRAIN_SET_FILENAME))
    n_test = len(_read_split(folder, loop.TEST_SET_FILENAME))
    full, rem = divmod(n_train, STREAM_CHUNK)
    per_epoch = full * (STREAM_CHUNK // BATCH) + rem // BATCH
    if rc != 0 or launches != steps or steps != 2 * per_epoch:
        raise AssertionError(f"streaming: rc {rc}, {launches} preprocess "
                             f"launches for {steps} steps ({per_epoch} an "
                             "epoch)")
    decoded = [(int(n), float(sec), int(c)) for n, sec, c in re.findall(
        r"stream: decoded (\d+) frames in ([\d.]+)s, (\d+) from the cache",
        text)]
    if len(decoded) != 2 or decoded[0][0] != n_train + n_test \
            or decoded[1][0] != 0 or decoded[1][2] != n_train + n_test:
        raise AssertionError(f"streaming: decodes by epoch {decoded}")
    records = _folder_records(folder)
    _check_records(records, n_test, 2)
    cache_mb = 0.0
    canonical = max(256, CROP)  # the train CLI's
    for split, arena in arenas.items():
        path = cache_file(folder, split, canonical)
        cache = np.load(path, mmap_mode="r")
        bad = np.fromfile(path + ".bad", np.int64)
        if cache.shape != arena.transpose(0, 2, 3, 1).shape or len(bad) or \
                not np.array_equal(np.asarray(cache).transpose(0, 3, 1, 2),
                                   arena):
            raise AssertionError(f"streaming: the {split} cache "
                                 f"{cache.shape} (bad rows {bad.tolist()}) "
                                 "differs from the cli phase's arena")
        cache_mb += os.path.getsize(path) / 1e6
    line = {
        "phase": "streaming", "chunk": STREAM_CHUNK, "batch": BATCH,
        "train_rows": n_train, "test_rows": n_test, "steps": steps,
        "launches": launches, "steps_per_epoch": per_epoch,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "epoch_s": [r["epoch_time_s"] for r in records],
        "img_per_s": [per_epoch * BATCH / r["epoch_time_s"]
                      for r in records],
        "eval_s": [r["eval_time_s"] for r in records],
        "decode_s_epoch1": decoded[0][1],
        "frames_decoded": [d[0] for d in decoded],
        "frames_from_cache": [d[2] for d in decoded],
        "cache_mb": cache_mb, "cache_equals_cli_arena": True,
        "wall_s": wall, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


def _recorded_run(torch, run):
    """``run()`` with the preprocess kernel's launch count set to 0 just
    before it and every train step's (loss, count) recorded: (its result,
    launches, live losses, live steps, wall seconds)."""
    import numpy as np

    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.train import loop

    steps = []

    def record(step):
        def call(*a, **kw):
            m = step(*a, **kw)
            steps.append((m["loss"].reshape(-1), m["count"].reshape(-1)))
            return m
        return call

    fused_preprocess_planar.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with _Patch(loop, "multi_train_step", record), \
            _Patch(loop, "train_step", record):
        result = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = fused_preprocess_planar.launches
    losses = torch.cat([lo for lo, _ in steps]).float().cpu().numpy()
    live = torch.cat([c for _, c in steps]).cpu().numpy() > 0
    if not np.isfinite(losses[live]).all():
        raise AssertionError(f"non-finite losses {losses[live]}")
    return result, launches, losses[live], int(live.sum()), wall


def _flagship_run_config(cfg_lib, root: str, results: str, epochs: int,
                         **data):
    """The flagship at full width over the cohort at ``root``, as phase
    ``train`` runs it: B=256, 224 crops of 256 frames with the jitter,
    bf16 compute, adam with both moments in bf16, K steps a call."""
    return cfg_lib.TrainConfig(
        epochs=epochs, seed=0, results_dir=results,
        data=cfg_lib.DataConfig(
            root_dir=root, image_size=CROP, canonical_size=SIZE,
            batch_size=BATCH, augment=True, balance=True,
            steps_per_dispatch=K, seed=0, **data),
        model=cfg_lib.ModelConfig(compute_dtype="bfloat16",
                                  image_size=CROP),
        optim=cfg_lib.OptimConfig(learning_rate=1e-5,
                                  moment_dtype="bfloat16",
                                  nu_dtype="bfloat16"),
    )


def phase_hostfeed(torch, work: str, root: str) -> dict:
    """``run_training`` over the cli phase's cohort with the arenas on the
    card, then with ``device_cache=False`` (host batches from
    ``BatchIterator``, the preprocess kernel on each uploaded batch, its
    ``rows=None`` form) without and with prefetching, 3 epochs each at
    full width; times one batch's gather and upload apart. Checks one
    launch per train step in each, one preprocess device kernel per host-fed
    step (``device_kernels`` over a host-fed epoch), finite losses,
    complete records; that the first host batch holds the arena's rows
    and preprocesses bit for bit as the arena feed does for the same
    rows and draws; and the kernel's ``rows=None`` call on that batch
    against its plain version."""
    import numpy as np

    from skin_image_analysis_tpu_torch import config as cfg_lib
    from skin_image_analysis_tpu_torch.data.loader import BatchIterator
    from skin_image_analysis_tpu_torch.ops import preprocess as pre_mod
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar_ref,
    )
    from skin_image_analysis_tpu_torch.tools.perf_attrib import (
        device_kernels,
    )
    from skin_image_analysis_tpu_torch.train import loop

    dev = torch.device("cuda")
    epochs = 3
    runs, host_epoch = {}, []

    def capture(fn):
        def call(*a, **kw):
            host_epoch[:] = [a]
            return fn(*a, **kw)
        return call

    # host_serial makes each batch in the step's thread (no prefetch), so
    # its gather and upload cannot overlap the step; the host feed's last,
    # so that the epoch captured below is the prefetching feed's
    for feed, data in (("arena", {}),
                       ("host_serial", {"device_cache": False,
                                        "prefetch_depth": 0}),
                       ("host", {"device_cache": False})):
        cfg = _flagship_run_config(cfg_lib, root,
                                   os.path.join(work, f"results_{feed}"),
                                   epochs, **data)
        with _Patch(loop, "_train_epoch_host", capture):
            folder, launches, losses, steps, wall = _recorded_run(
                torch, lambda: loop.run_training(cfg, verbose=False,
                                                 device="cuda"))
        n_train = len(_read_split(folder, loop.TRAIN_SET_FILENAME))
        n_test = len(_read_split(folder, loop.TEST_SET_FILENAME))
        per_epoch = n_train // BATCH
        if launches != steps or steps != epochs * per_epoch:
            raise AssertionError(f"{feed} feed: {launches} launches for "
                                 f"{steps} steps ({per_epoch} an epoch)")
        records = _folder_records(folder)
        _check_records(records, n_test, epochs)
        warm = [r["epoch_time_s"] for r in records[1:]]
        runs[feed] = {
            "launches": launches, "steps": steps, "wall_s": wall,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "epoch_time_s": [r["epoch_time_s"] for r in records],
            "eval_time_s": [r["eval_time_s"] for r in records],
            "warm_epoch_img_per_s": per_epoch * BATCH / np.mean(warm),
        }
    if not host_epoch:
        raise AssertionError("device_cache=False did not feed host batches")

    # one preprocess device kernel per host-fed step, from the profiler
    state, loader, class_weights, train_pre = host_epoch[0][:4]
    evs = device_kernels(lambda: loop._train_epoch_host(
        state, loader, class_weights, train_pre))
    pre_kernels = sum(ev.count for ev in evs
                      if _kernel_group(ev.key).startswith("preprocess"))
    if pre_kernels != len(loader):
        raise AssertionError(f"{pre_kernels} preprocess device kernels in "
                             f"a host-fed epoch of {len(loader)} steps")

    # the first host batch against the arena feed: the same rows, the
    # same draws, the same preprocessed batch bit for bit
    store = loader.store
    first_it = iter(BatchIterator(store, BATCH, device=dev, shuffle=True,
                                  drop_remainder=True, seed=1))
    first = next(first_it)
    first_it.close()
    order = np.arange(len(store))
    np.random.default_rng(1).shuffle(order)
    idx = torch.from_numpy(order[:BATCH].astype(np.int32)).to(dev)
    arena = store.to_device(dev)
    calls = []

    def record_kernel(kernel):
        def call(*a, **kw):
            out = kernel(*a, **kw)
            calls.append((a, kw, out))
            return out
        return call

    with _Patch(pre_mod, "fused_preprocess_planar", record_kernel):
        host_out = train_pre(first["pixels"],
                             torch.Generator(dev).manual_seed(7))
        arena_out = train_pre(arena, torch.Generator(dev).manual_seed(7),
                              rows=idx)
    same_rows = torch.equal(first["pixels"], arena[idx.long()])
    bit_identical = torch.equal(host_out, arena_out)
    (args, kw, kernel_out), _ = calls
    if args[5] is not None:
        raise AssertionError("the host-fed step passed rows to the kernel")
    plain = fused_preprocess_planar_ref(*args, **kw)
    err = (kernel_out.float() - plain.float()).abs()
    held = bool((err <= bf16_tol(plain)).all())
    if not (same_rows and bit_identical and held):
        raise AssertionError(f"first host batch: rows {same_rows}, bit "
                             f"identical to the arena feed {bit_identical}, "
                             f"rows=None kernel within 1 bf16 ulp of plain "
                             f"{held} (max abs err {float(err.max())})")
    del arena

    # what the prefetch thread hides: one batch's host gather into pinned
    # memory, and its upload
    images = torch.from_numpy(store.images)
    buf = torch.empty((BATCH, *images.shape[1:]), dtype=torch.uint8,
                      pin_memory=True)
    rows = torch.from_numpy(order[:BATCH].astype(np.int64))
    gather_ms, upload_ms = [], []
    for _ in range(5):
        t = time.perf_counter()
        torch.index_select(images, 0, rows, out=buf)
        gather_ms.append((time.perf_counter() - t) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        buf.to(dev, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        upload_ms.append(start.elapsed_time(end))
    line = {
        "phase": "hostfeed", "batch": BATCH, "k": K, "epochs": epochs,
        "train_rows": n_train, "test_rows": n_test,
        "steps_per_epoch": per_epoch, **{f"{feed}_feed": r
                                         for feed, r in runs.items()},
        "host_vs_arena_warm_img_per_s": (
            runs["host"]["warm_epoch_img_per_s"]
            / runs["arena"]["warm_epoch_img_per_s"]),
        "serial_vs_arena_warm_img_per_s": (
            runs["host_serial"]["warm_epoch_img_per_s"]
            / runs["arena"]["warm_epoch_img_per_s"]),
        "batch_bytes": buf.numel(),
        "gather_ms_median": sorted(gather_ms)[2],
        "upload_ms_median": sorted(upload_ms)[2],
        "upload_gb_per_s": buf.numel() / sorted(upload_ms)[2] / 1e6,
        "launches": {feed: r["launches"] for feed, r in runs.items()},
        "preprocess_device_kernels_per_host_step": pre_kernels / len(loader),
        "first_batch_rows_equal": same_rows,
        "first_batch_bit_identical_to_arena_feed": bit_identical,
        "rows_none_max_abs_err": float(err.max()),
        "rows_none_held": "1 bf16 ulp (at least 1e-5)",
        "card": nvidia_smi_line(),
    }
    emit(line)
    return line


def phase_elastic(torch, work: str, root: str) -> dict:
    """``tone_bias_train <root> 3 balance --augment --batch-size 256
    --auto-resume 1`` with an ``SIA_FAULT_ONCE`` sentinel, which fails the
    run once after its first epoch: the supervisor resumes the folder for
    the other two. Checks two attempts, the sentinel consumed, progress 3
    and three epoch records, one kernel launch per train step across both
    attempts, finite losses; reports the restart's cost (the fault to the
    resumed attempt's first step)."""
    import contextlib
    import io

    from skin_image_analysis_tpu_torch.cli import tone_bias_train
    from skin_image_analysis_tpu_torch.train import loop

    here = os.path.join(work, "elastic")
    os.makedirs(here)
    sentinel = os.path.join(here, "fault_once")
    open(sentinel, "w").close()
    attempts = []

    def attempt(run):
        def call(*a, **kw):
            rec = {"start": time.perf_counter(), "first_step": None}
            attempts.append(rec)
            try:
                return run(*a, **kw)
            finally:
                torch.cuda.synchronize()
                rec["end"] = time.perf_counter()
        return call

    def first_step(step):
        def call(*a, **kw):
            if attempts[-1]["first_step"] is None:
                attempts[-1]["first_step"] = time.perf_counter()
            return step(*a, **kw)
        return call

    cwd = os.getcwd()
    log = io.StringIO()
    argv = [root, "3", "balance", "--augment", "--batch-size", str(BATCH),
            "--image-size", str(CROP), "--steps-per-dispatch", str(K),
            "--seed", "0", "--auto-resume", "1"]
    os.environ["SIA_FAULT_ONCE"] = sentinel
    try:
        os.chdir(here)
        with _Patch(loop, "run_training", attempt), \
                _Patch(loop, "multi_train_step", first_step), \
                contextlib.redirect_stdout(log):
            _, launches, losses, steps, wall = _recorded_run(
                torch, lambda: tone_bias_train.main(argv))
        [folder] = os.listdir(os.path.join(here, "results"))
        folder = os.path.join(here, "results", folder)
        n_train = len(_read_split(folder, loop.TRAIN_SET_FILENAME))
        n_test = len(_read_split(folder, loop.TEST_SET_FILENAME))
        per_epoch = n_train // BATCH
        records = _folder_records(folder)
        _check_records(records, n_test, 3)
        with open(os.path.join(folder, loop.PROGRESS_FILENAME)) as f:
            markers = [int(v) for v in f if v.strip()]
        if len(attempts) != 2 or os.path.exists(sentinel) \
                or "auto-resume: restart 1/1" not in log.getvalue() \
                or loop.completed_epochs(folder) != 3:
            raise AssertionError(f"{len(attempts)} attempts, sentinel left "
                                 f"{os.path.exists(sentinel)}, progress "
                                 f"{markers}")
        if launches != steps or steps != 3 * per_epoch:
            raise AssertionError(f"{launches} launches for {steps} steps "
                                 f"({per_epoch} an epoch)")
    except BaseException:
        print(log.getvalue()[-4000:], file=sys.stderr)
        raise
    finally:
        os.environ.pop("SIA_FAULT_ONCE", None)
        os.chdir(cwd)
    first, second = attempts
    line = {
        "phase": "elastic", "epochs": 3, "batch": BATCH, "k": K,
        "train_rows": n_train, "attempts": 2, "progress_markers": markers,
        "records": len(records), "steps": steps, "launches": launches,
        "sentinel_consumed": True,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "attempt_s": [first["end"] - first["start"],
                      second["end"] - second["start"]],
        "restart_s": second["first_step"] - first["end"],
        "first_attempt_to_first_step_s": first["first_step"]
        - first["start"],
        "wall_s": wall, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


def phase_predict(torch, ctx: dict) -> dict:
    """``tone_bias_predict`` on the cli phase's folder over its test rows
    (the folder's ``session_test.csv``) and with ``--images`` over the
    directory of their 224 crops. Checks a row per test row in each,
    p_malignant in [0, 1], the predictions and scores beside the test
    CLI's on the same rows (a class may differ only where the score is
    within 1e-3 of 0.5; scores within 1e-3), the two modes alike, and
    the predictions against a float32 CPU forward of the checkpoint."""
    import contextlib
    import csv
    import io

    import numpy as np

    from skin_image_analysis_tpu_torch.cli import tone_bias_predict

    folder, root224 = ctx["folder"], ctx["root224"]
    test_ids = ctx["test_ids"]
    names = ("benign", "malignant")
    tol = 1e-3
    outs, seconds = {}, {}
    for mode, flags in (("test_split", []), ("images", ["--images"])):
        path = os.path.join(ctx["work"], f"predict_{mode}.csv")
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            if tone_bias_predict.main([root224, folder, path, *flags]) != 0:
                raise AssertionError(f"tone_bias_predict {mode} failed")
        seconds[mode] = time.perf_counter() - t
        with open(path, newline="") as f:
            outs[mode] = list(csv.DictReader(f))
    by_split, by_images = outs["test_split"], outs["images"]
    if [r["isic_id"] for r in by_split] != test_ids \
            or [r["isic_id"] for r in by_images] != sorted(test_ids):
        raise AssertionError(f"predict rows: {len(by_split)} and "
                             f"{len(by_images)} for {len(test_ids)} test "
                             "rows")
    test_cli = ctx["test_predictions"]
    score = np.empty(len(test_ids))
    score[test_cli["row_id"]] = test_cli["score_malignant"]
    card_pred = np.empty(len(test_ids), np.int64)
    card_pred[test_cli["row_id"]] = test_cli["pred"]
    p = np.array([float(r["p_malignant"]) for r in by_split])
    pred = np.array([names.index(r["prediction"]) for r in by_split])
    near = np.abs(score - 0.5) <= tol
    differ = int(((pred != card_pred) & ~near).sum())
    score_err = float(np.abs(p - score).max())
    images = {r["isic_id"]: r for r in by_images}
    p_img = np.array([float(images[i]["p_malignant"]) for i in test_ids])
    pred_img = np.array([names.index(images[i]["prediction"])
                         for i in test_ids])
    modes_err = float(np.abs(p_img - p).max())
    modes_differ = int(((pred_img != pred) & ~near).sum())
    if not ((p >= 0) & (p <= 1)).all() or differ or score_err > tol \
            or modes_err > tol or modes_differ:
        raise AssertionError(f"predict: {differ} classes differ from the "
                             f"test CLI's (score err {score_err}); the two "
                             f"modes {modes_differ} (err {modes_err})")
    n_ref, decided, flipped = _cpu_reference(torch, folder, root224,
                                             test_ids, pred)
    line = {
        "phase": "predict", "rows": len(by_split),
        "images_rows": len(by_images), "predict_s": seconds,
        "max_abs_diff_vs_test_cli": score_err,
        "class_changes_vs_test_cli": differ,
        "max_abs_diff_between_modes": modes_err,
        "near_ties": int(near.sum()), "tol": tol,
        "reference_rows": n_ref, "decided_rows": decided,
        "class_changes": flipped, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


def _trace_kernels(path: str, name: str) -> tuple[int, int]:
    """(device kernel events whose name holds ``name``, all events) of a
    Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return (sum(1 for e in events if e.get("cat") == "kernel"
                and name in e.get("name", "")), len(events))


def _epoch_s(folder: str) -> float:
    [record] = _folder_records(folder)
    return record["epoch_time_s"]


def phase_cli_tools(torch, work: str, root: str, ctx: dict,
                    cli: dict) -> dict:
    """The train CLI's ``--profile`` and ``--debug-nans`` and the
    metadata, dataset and monitor CLIs on the cli phase's cohort, in their
    own working directory: ``tone_bias_train <root> 1 balance`` with the
    cli phase's flags under ``--profile`` (the Chrome trace must parse and
    hold one ``preprocess_cluster_kernel`` device event per train step),
    then under ``--debug-nans`` (finite, one launch a step), then with
    ``--debug-nans`` and ``--init-from`` a copy of the cli folder whose
    first conv weight holds one NaN (FloatingPointError naming train step
    1's log-probs);
    ``tone_bias_metadata`` on the cohort's metadata.csv;
    ``tone_bias_dataset <copy of the cohort> balance`` on the frames'
    224² centre crops, the CLI's fixed size (rows written, every train row
    iterated); ``monitor_processes``
    once (where psutil is missing the line says so). Each epoch's time
    is printed beside the cli phase's unprofiled epochs."""
    import contextlib
    import io

    import numpy as np

    from skin_image_analysis_tpu_torch.cli import (
        monitor_processes,
        tone_bias_dataset,
        tone_bias_metadata,
        tone_bias_train,
    )
    from skin_image_analysis_tpu_torch.data.dicom import read_dicom_image
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt
    from skin_image_analysis_tpu_torch.train import loop

    here = os.path.join(work, "tools")
    os.makedirs(here)
    args = ["--augment", "--batch-size", str(BATCH), "--image-size",
            str(CROP), "--steps-per-dispatch", str(K), "--seed", "0"]
    cwd = os.getcwd()
    log = io.StringIO()
    runs = {}
    try:
        os.chdir(here)

        def run(name, *flags):
            results = os.path.join(here, name)
            os.makedirs(results)
            os.chdir(results)
            with contextlib.redirect_stdout(log):
                rc, launches, losses, steps, wall = _recorded_run(
                    torch, lambda: tone_bias_train.main(
                        [root, "1", "balance", *args, *flags]))
            [folder] = os.listdir(os.path.join(results, "results"))
            folder = os.path.join(results, "results", folder)
            per_epoch = len(_read_split(
                folder, loop.TRAIN_SET_FILENAME)) // BATCH
            if rc != 0 or launches != steps or steps != per_epoch:
                raise AssertionError(f"{name}: {launches} launches for "
                                     f"{steps} steps ({per_epoch} an epoch)")
            runs[name] = {"steps": steps, "launches": launches,
                          "loss_first": float(losses[0]),
                          "loss_last": float(losses[-1]), "wall_s": wall,
                          "epoch_time_s": _epoch_s(folder)}
            return folder

        prof = os.path.join(here, "prof")
        run("profile", "--profile", prof)
        [trace_name] = os.listdir(prof)
        path = os.path.join(prof, trace_name)
        t = time.perf_counter()
        events, n_events = _trace_kernels(path, "preprocess_cluster_kernel")
        runs["profile"].update(
            trace_mb=os.path.getsize(path) / 1e6, trace_events=n_events,
            trace_parse_s=time.perf_counter() - t,
            preprocess_kernel_events=events)
        if events != runs["profile"]["steps"]:
            raise AssertionError(f"the trace holds {events} preprocess "
                                 f"kernel events for "
                                 f"{runs['profile']['steps']} train steps")
        run("debug_nans", "--debug-nans")

        # one NaN in the first conv weight: the first step must raise
        poisoned = os.path.join(here, "poisoned")
        os.makedirs(poisoned)
        model_cfg, state_dict = ckpt.load_model(
            os.path.join(ctx["folder"], ckpt.MODEL_FILENAME))
        state_dict["conv_blocks.0.weight"][0, 0, 0, 0] = float("nan")
        ckpt.save_model(os.path.join(poisoned, ckpt.MODEL_FILENAME),
                        model_cfg, state_dict)
        os.makedirs(os.path.join(here, "nan"))
        os.chdir(os.path.join(here, "nan"))
        fused_preprocess_planar.launches = 0
        try:
            with contextlib.redirect_stdout(log):
                tone_bias_train.main([root, "1", "balance", *args,
                                      "--init-from", poisoned,
                                      "--debug-nans"])
        except FloatingPointError as e:
            nan_error = str(e)
        else:
            raise AssertionError("--debug-nans trained on a NaN weight")
        nan_launches = fused_preprocess_planar.launches
        if "non-finite log-probs in train step 1" not in nan_error \
                or nan_launches != 1 \
                or torch.is_anomaly_enabled():
            raise AssertionError(f"--debug-nans on a NaN weight: "
                                 f"{nan_error!r} after {nan_launches} "
                                 "launches")
        os.chdir(here)

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tone_bias_metadata.main([os.path.join(root,
                                                       "metadata.csv")])
        metadata = out.getvalue()
        if rc != 0 or f"records: {COHORT_ROWS}" not in metadata:
            raise AssertionError(f"tone_bias_metadata: {metadata[:400]}")

        # the dataset CLI writes into its root and decodes at its fixed
        # 224²: a copy of the cohort with every frame's centre crop, so no
        # frame needs cv2 or PIL to resize
        copy = os.path.join(here, "cohort")
        os.makedirs(copy)
        shutil.copy(os.path.join(root, "metadata.csv"), copy)
        lo = (SIZE - CROP) // 2
        t = time.perf_counter()
        for name in os.listdir(root):
            if name.endswith(".dcm"):
                frame = read_dicom_image(os.path.join(root, name))
                with open(os.path.join(copy, name), "wb") as f:
                    f.write(_dicom_rgb(np.ascontiguousarray(
                        frame[lo:lo + CROP, lo:lo + CROP])))
        crops_s = time.perf_counter() - t
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = tone_bias_dataset.main([copy, "balance"])
        dataset_s = time.perf_counter() - t
        text = out.getvalue()
        with open(os.path.join(copy, "balanced_metadata.csv")) as f:
            written = sum(1 for _ in f) - 1
        decoded = int(text.split("decoded ")[1].split()[0])
        iterated = int(text.split("iterated ")[1].split()[0])
        if rc != 0 or decoded != int(0.7 * written) or iterated != decoded:
            raise AssertionError(f"tone_bias_dataset: {written} rows "
                                 f"written, {decoded} decoded, {iterated} "
                                 "iterated")

        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                monitor_processes.main([])
            monitor = (f"{len(out.getvalue().splitlines()) - 1} python "
                       "processes")
        except ImportError as e:
            if "psutil" not in str(e):
                raise
            monitor = f"psutil missing: {e}"
    except BaseException:
        print(log.getvalue()[-4000:], file=sys.stderr)
        raise
    finally:
        os.chdir(cwd)
    line = {
        "phase": "cli_tools", **runs,
        "unprofiled_epoch_time_s": cli["epoch_time_s"],
        "nan_error": nan_error, "nan_launches": nan_launches,
        "metadata_lines": len(metadata.splitlines()),
        "dataset": {"rows_written": written, "decoded": decoded,
                    "iterated": iterated, "s": dataset_s,
                    "crops_written_s": crops_s},
        "monitor": monitor, "card": nvidia_smi_line(),
    }
    line["launches"] = (runs["profile"]["launches"]
                        + runs["debug_nans"]["launches"] + nan_launches)
    emit(line)
    return line


def _reference_module_class(nn):
    """The reference's ``SkinCancerListModel`` at full width, as the
    reference builds it from torch primitives. ``torch.save`` of a whole
    module pickles its class by module path, so the class is published at
    this module's top level."""
    class SkinCancerListModel(nn.Module):
        def __init__(self):
            super().__init__()
            layers, prev, side = [], 3, CROP
            for i, feats in enumerate((32, 64, 128)):
                layers += [nn.Conv2d(prev, feats, 7 if i == 0 else 3,
                                     padding="same"),
                           nn.ReLU(), nn.MaxPool2d(2, 2)]
                prev, side = feats, side // 2
            layers.append(nn.Flatten())
            prev *= side * side  # 128 * 28 * 28 = 100352
            for feats in (512, 256):
                layers += [nn.Linear(prev, feats), nn.ReLU(),
                           nn.Dropout(0.5)]
                prev = feats
            layers += [nn.Linear(prev, 2), nn.LogSoftmax(dim=1)]
            self.layers = nn.Sequential(*layers)
            self.class_names = ["benign", "malignant"]

        def forward(self, x):
            return self.layers(x)

    SkinCancerListModel.__qualname__ = "SkinCancerListModel"
    globals()["SkinCancerListModel"] = SkinCancerListModel
    return SkinCancerListModel


# The imported model on the card against the pickled module on the CPU,
# both float32 with TF32 off: the CPU migrate tests' tolerance. The seeded,
# untrained module's log-probs lie within about 0.02 of log(1/2), so a
# looser limit (5e-3) let a conv kernel with H and W swapped through
# (2.4e-3 off in a CPU rehearsal on 4 random images).
MIGRATE_ATOL, MIGRATE_RTOL = 2e-5, 1e-4


def phase_migrate(torch, work: str, root: str, ctx: dict) -> dict:
    """The reference's checkpoint into the port, on the card: a
    reference-shaped whole ``SkinCancerListModel`` at full width with
    seeded weights, ``torch.save``d as ``session_model.pth`` beside the cli
    folder's split CSVs and epoch records; ``import_reference`` of that
    folder; the imported model's float32 forward on the card held against
    the pickled module's own float32 forward on the CPU over 64 test rows
    (the same plain-preprocessed input, TF32 off, within ``MIGRATE_ATOL``
    plus ``MIGRATE_RTOL`` of the CPU's log-probs, as the CPU migrate tests
    hold it, and no class change), and the same import with every conv
    kernel's H and W swapped held to be outside that limit, so the check
    can see a wrong mapping; ``tone_bias_test`` on the imported folder;
    and one epoch of ``tone_bias_train`` continuing it (finite losses, one
    preprocess launch a step)."""
    import contextlib
    import glob
    import io

    import numpy as np
    from torch import nn

    from skin_image_analysis_tpu_torch.cli import (
        import_reference,
        tone_bias_test,
        tone_bias_train,
    )
    from skin_image_analysis_tpu_torch.data.dataset import LesionTable
    from skin_image_analysis_tpu_torch.data.ingest import read_csv
    from skin_image_analysis_tpu_torch.data.loader import HostImageStore
    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt
    from skin_image_analysis_tpu_torch.train import loop

    here = os.path.join(work, "migrate")
    src, out_dir = os.path.join(here, "reference"), os.path.join(here,
                                                                 "imported")
    os.makedirs(src)
    torch.manual_seed(0)
    module = _reference_module_class(nn)()
    module.eval()
    t = time.perf_counter()
    torch.save(module, os.path.join(src, "session_model.pth"))
    save_s = time.perf_counter() - t
    folder = ctx["folder"]
    for name in (loop.TRAIN_SET_FILENAME, loop.TEST_SET_FILENAME,
                 *[os.path.basename(p) for p in glob.glob(
                     os.path.join(folder, "[0-9]*.json"))]):
        shutil.copy(os.path.join(folder, name), src)
    cwd = os.getcwd()
    log = io.StringIO()
    try:
        os.chdir(here)
        t = time.perf_counter()
        with contextlib.redirect_stdout(log):
            if import_reference.main([src, out_dir]) != 0:
                raise AssertionError("import_reference failed")
        import_s = time.perf_counter() - t
        model_cfg, state_dict = ckpt.load_model(
            os.path.join(out_dir, ckpt.MODEL_FILENAME))
        if model_cfg.compute_dtype != "float32" \
                or model_cfg.conv_features != (32, 64, 128) \
                or model_cfg.linear_features != (512, 256) \
                or model_cfg.image_size != CROP:
            raise AssertionError(f"imported config {model_cfg}")

        # the card's float32 forward against the pickled module's on the CPU
        test_ids = ctx["test_ids"]
        n = min(64, len(test_ids))
        table = LesionTable(read_csv(os.path.join(
            out_dir, loop.TEST_SET_FILENAME), index_col=True).take(
                range(n)), ctx["root224"])
        x = make_preprocess_fn(CROP, train=False, layout="planar")(
            HostImageStore(table, CROP).to_device("cpu"))
        with torch.no_grad():
            want = module(x.permute(0, 3, 1, 2))
        card = build_model(model_cfg, device="cuda")
        card.eval()

        def card_forward(sd):
            card.load_state_dict(sd)
            with torch.no_grad():
                out = card(x.cuda(), train=False).float().cpu()
            excess = (out - want).abs() - MIGRATE_RTOL * want.abs()
            return out, float((out - want).abs().max()), float(excess.max())

        got, err, excess = card_forward(state_dict)
        class_changes = int((got.argmax(1) != want.argmax(1)).sum())
        if not torch.isfinite(got).all() or excess > MIGRATE_ATOL \
                or class_changes:
            raise AssertionError(f"imported forward on the card is {err} "
                                 "from the pickled module's on the CPU, "
                                 f"{class_changes} class changes")
        swapped = {k: v.transpose(2, 3).contiguous() if v.dim() == 4
                   else v for k, v in state_dict.items()}
        _, swapped_err, swapped_excess = card_forward(swapped)
        if swapped_excess <= MIGRATE_ATOL:
            raise AssertionError(f"conv kernels with H and W swapped are "
                                 f"only {swapped_err} from the pickled "
                                 "module: the check cannot see a wrong "
                                 "import")
        del card

        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if tone_bias_test.main([ctx["root224"], out_dir]) != 0:
                raise AssertionError("tone_bias_test on the import failed")
        test_cli_s = time.perf_counter() - t
        text = out.getvalue()
        log.write(text)
        record = json.loads(text[text.index("{"):text.rindex("}") + 1])
        if record["total"] != len(test_ids):
            raise AssertionError(f"test CLI covered {record['total']} of "
                                 f"{len(test_ids)} rows")

        # the copied epoch records count as the folder's epochs
        done = loop.completed_epochs(out_dir)
        with contextlib.redirect_stdout(log):
            rc, launches, losses, steps, wall = _recorded_run(
                torch, lambda: tone_bias_train.main(
                    [root, "1", out_dir, "--augment", "--batch-size",
                     str(BATCH), "--image-size", str(CROP),
                     "--steps-per-dispatch", str(K), "--seed", "0"]))
        per_epoch = len(_read_split(out_dir,
                                    loop.TRAIN_SET_FILENAME)) // BATCH
        if rc != 0 or launches != steps or steps != per_epoch \
                or loop.completed_epochs(out_dir) != done + 1:
            raise AssertionError(f"continued training: {launches} "
                                 f"launches for {steps} steps "
                                 f"({per_epoch} an epoch), epochs "
                                 f"{done} -> "
                                 f"{loop.completed_epochs(out_dir)}")
    except BaseException:
        print(log.getvalue()[-4000:], file=sys.stderr)
        raise
    finally:
        os.chdir(cwd)
    line = {
        "phase": "migrate", "pth_mb": os.path.getsize(os.path.join(
            src, "session_model.pth")) / 1e6,
        "torch_save_s": save_s, "import_s": import_s,
        "msgpack_mb": os.path.getsize(os.path.join(
            out_dir, ckpt.MODEL_FILENAME)) / 1e6,
        "forward_rows": n, "forward_max_abs_err": err,
        "atol": MIGRATE_ATOL, "rtol": MIGRATE_RTOL,
        "log_prob_spread": float((want - math.log(0.5)).abs().max()),
        "swapped_hw_max_abs_err": swapped_err,
        "class_changes": class_changes,
        "test_cli_s": test_cli_s, "test_accuracy": record["accuracy"],
        "epochs_before": done, "train_steps": steps, "launches": launches,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "train_wall_s": wall, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


# The transfer phases: the transfer trainer at full width, at the tone
# classifier's operating point (B=32, 224 crops of 256 frames, adamw lr
# 1e-3): resnet50 (phase transfer), xception (phase xception) and resnet50
# on the ITA input (phase ita). Its bf16 eval is held to the CPU's float32
# forward within TRANSFER_BF16_ATOL: 53 layers of bf16 rounding in
# resnet50 (a CPU rehearsal at 32² measured 9.4e-3 between its bf16 and
# float32 log-probs); its float32 eval to 5e-3.
TRANSFER_BATCH, TRANSFER_K = 32, 8
TRANSFER_BF16_ATOL = 3e-2
# The ITA phase's seeded frames: light and dark skin colours with noise
SKIN_RGB = ((215, 170, 140), (130, 88, 62))
ITA_ROWS = 64


# The transfer phases train on the first TRANSFER_TRAIN_ROWS rows of
# their 70% split (about 2,000 rows), the whole 30% test split kept
TRANSFER_TRAIN_ROWS = 1024


def _tone_tables(root: str):
    """The cohort's tone tables, split 70/30 as ``tone_classifier_train``
    splits them: Fitzpatrick I/II light, III-VI dark, rows without a type
    dropped; the train table cut to TRANSFER_TRAIN_ROWS rows."""
    from skin_image_analysis_tpu_torch.data.dataset import LesionTable
    from skin_image_analysis_tpu_torch.data.ingest import (
        read_csv,
        shuffle_split,
    )

    df = read_csv(os.path.join(root, "metadata.csv"))
    df = df.where("fitzpatrick_skin_type", lambda v: v is not None)
    df = df.with_column("tone_label", [
        "light" if t in ("I", "II") else "dark"
        for t in df.column("fitzpatrick_skin_type")])
    train, test = (LesionTable(d, root, class_names=("light", "dark"),
                               label_column="tone_label")
                   for d in shuffle_split(df, ratio=0.7, seed=0))
    return _first_rows(train, TRANSFER_TRAIN_ROWS), test


def _lesion_tables(root: str):
    """The cohort's benign/malignant tables, split 70/30 (seed 0), the
    train table cut to TRANSFER_TRAIN_ROWS rows."""
    from skin_image_analysis_tpu_torch.data.dataset import LesionTable
    from skin_image_analysis_tpu_torch.data.ingest import (
        read_csv,
        shuffle_split,
    )

    df = read_csv(os.path.join(root, "metadata.csv"))
    train, test = (LesionTable(d, root)
                   for d in shuffle_split(df, ratio=0.7, seed=0))
    return _first_rows(train, TRANSFER_TRAIN_ROWS), test


def _transfer_check_kernel(torch, arena, imagenet: bool = True) -> dict:
    """The transfer step's preprocess call (no tail, float32 out: crop
    256 -> 224, flip, and the ImageNet affine folded into the per-image
    scale and bias, or with ``imagenet=False`` the ITA input's identity
    affine, /255 only) at B=32 rows of the run's own 256² train arena,
    held against the plain version and timed beside it."""
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
        fused_preprocess_planar_ref,
    )
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from skin_image_analysis_tpu_torch.tools.perf_attrib import (
        cuda_ms,
        l2_flusher,
    )

    dev = arena.device
    b, t = TRANSFER_BATCH, CROP
    g = torch.Generator(device=dev).manual_seed(12)
    rows = torch.randint(0, arena.shape[0], (b,), dtype=torch.int32,
                         device=dev, generator=g)
    offsets = torch.randint(0, arena.shape[2] - t + 1, (b, 2),
                            dtype=torch.int32, device=dev, generator=g)
    flips = torch.randint(0, 2, (b,), dtype=torch.int32, device=dev,
                          generator=g)
    if imagenet:
        std = torch.tensor(IMAGENET_STD, device=dev)
        mean = torch.tensor(IMAGENET_MEAN, device=dev)
        scale = (1 / 255 / std).expand(b, 3).contiguous()
        bias = (-mean / std).expand(b, 3).contiguous()
    else:
        scale = torch.full((b, 3), 1 / 255, device=dev)
        bias = torch.zeros((b, 3), device=dev)
    args = (arena, offsets, flips, scale, bias, rows)
    kw = dict(image_size=t, out_dtype=torch.float32)
    got = fused_preprocess_planar(*args, **kw)
    torch.cuda.synchronize()
    want = fused_preprocess_planar_ref(*args, **kw)
    err = float((got - want).abs().max())
    if got.shape != (b, 3, t, t) or err > 1e-6 \
            or not torch.isfinite(got).all():
        raise AssertionError(f"transfer preprocess call: max abs err {err} "
                             f"(atol 1e-6), shape {tuple(got.shape)}")
    flush = l2_flusher(dev)
    n_px = b * 3 * t * t
    moved = n_px + 4 * n_px + 4 * (rows.numel() + offsets.numel()
                                   + flips.numel() + 2 * b * 3)
    bytes_ms = moved / mem_rate(torch.cuda.get_device_name(0)) * 1e3
    ops_ms = 2 * n_px / _F32_PEAK * 1e3
    return {
        "variant": "no_tail_f32_b32" if imagenet else "identity_f32_b32",
        "shape": [b, 3, t, t],
        "arena": list(arena.shape), "max_abs_err": err, "held": "atol 1e-6",
        "ms": cuda_ms(lambda: fused_preprocess_planar(*args, **kw), 20,
                      flush),
        "plain_ms": cuda_ms(lambda: fused_preprocess_planar_ref(*args, **kw),
                            5, flush),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": moved,
    }


# steps of the transfer phases' profiled call (fewer than a run's call of
# 8: the profiler's cost grows with the ~6,000 device kernels a step)
TRANSFER_PROFILE_STEPS = 2


def _transfer_call(torch, state, arena, labels):
    """One TRANSFER_PROFILE_STEPS-step call of the transfer train step
    (B=32, the preprocess kernel with the ImageNet affine, adamw) on the
    trained state; the state moves on, so this comes after the run's
    checks of it."""
    import numpy as np

    from skin_image_analysis_tpu_torch.ops.preprocess import (
        AugmentConfig,
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.train.step import multi_train_step

    pre = make_preprocess_fn(
        CROP, train=True, augment=AugmentConfig(True, True),
        normalize_imagenet=True, layout="planar")
    rng = np.random.default_rng(13)
    idx = rng.integers(0, arena.shape[0], (TRANSFER_PROFILE_STEPS,
                                           TRANSFER_BATCH)).astype(np.int32)
    lab = np.asarray(labels)[idx].astype(np.int32)
    valid = np.ones(idx.shape, bool)
    return lambda: multi_train_step(state, arena, idx, lab, valid, None, pre)


def _transfer_profile(torch, state, arena, labels, watch=()) -> dict:
    """:func:`_transfer_call` profiled (:func:`_profile`)."""
    return _profile(torch, _transfer_call(torch, state, arena, labels),
                    TRANSFER_PROFILE_STEPS, TRANSFER_BATCH, watch)


def _classify_config(out_dir: str, model: str, epochs: int,
                     freeze: bool = False, input_mode: str = "rgb"):
    from skin_image_analysis_tpu_torch.train import classify

    return classify.ClassifyConfig(
        model_name=model, num_classes=2, image_size=CROP,
        canonical_size=SIZE, batch_size=TRANSFER_BATCH, epochs=epochs,
        learning_rate=1e-3, weight_decay=0.01, optimizer="adamw",
        compute_dtype="bfloat16", steps_per_dispatch=TRANSFER_K,
        freeze_backbone=freeze, input_mode=input_mode, seed=0,
        out_dir=out_dir)


def _classify_run(torch, train_table, test_table, cfg) -> dict:
    """``train_classifier`` on the card, with its train calls, evals and
    decodes timed and the preprocess kernel's launch count set to 0 just
    before it. Checks finite losses and one preprocess launch per live
    train step, every batch of every epoch."""
    import numpy as np

    from skin_image_analysis_tpu_torch.data.loader import HostImageStore
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.train import classify

    events, arenas = [], []

    def timed(kind):
        def wrap(fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                events.append((kind, time.perf_counter() - t, out))
                return out
            return call
        return wrap

    def keep_arena(to_device):
        def call(store, device):
            arena = to_device(store, device)
            arenas.append(arena)
            return arena
        return call

    fused_preprocess_planar.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    with _Patch(classify, "multi_train_step", timed("train")), \
            _Patch(classify, "_evaluate", timed("eval")), \
            _Patch(classify, "HostImageStore", timed("decode")), \
            _Patch(HostImageStore, "to_device", keep_arena):
        out = classify.train_classifier(train_table, test_table, cfg,
                                        verbose=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = fused_preprocess_planar.launches
    epochs_out, train_s, steps, losses = [], 0.0, 0, []
    for kind, dt, res in events:
        if kind == "train":
            train_s += dt
            live = res["count"].cpu().numpy() > 0
            steps += int(live.sum())
            losses.append(res["loss"].cpu().numpy()[live])
        elif kind == "eval":
            epochs_out.append({"train_s": train_s, "steps": steps,
                               "eval_s": dt})
            train_s, steps = 0.0, 0
    losses = np.concatenate(losses)
    live_steps = sum(e["steps"] for e in epochs_out)
    per_epoch = len(train_table) // TRANSFER_BATCH
    name = f"{cfg.model_name} ({cfg.input_mode})"
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: non-finite losses {losses}")
    if launches != live_steps or live_steps != cfg.epochs * per_epoch:
        raise AssertionError(f"{name}: preprocess kernel launched "
                             f"{launches} times for {live_steps} live "
                             f"train steps ({per_epoch} an epoch)")
    return {"out": out, "wall": wall, "launches": launches,
            "epochs": epochs_out, "losses": losses, "arenas": arenas,
            "decode_s": sum(dt for kind, dt, _ in events
                            if kind == "decode")}


def _initial_state(torch, cfg) -> dict:
    """The state_dict the run started from (the same seed on the card)."""
    from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig
    from skin_image_analysis_tpu_torch.train.state import create_train_state

    model_cfg = ModelConfig(
        name=cfg.model_name, num_classes=cfg.num_classes,
        image_size=cfg.image_size, compute_dtype=cfg.compute_dtype,
        freeze_backbone=cfg.freeze_backbone,
        in_channels=2 if cfg.input_mode == "ita" else 3)
    state = create_train_state(model_cfg, OptimConfig(), cfg.seed,
                               device="cuda")
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _check_bn(torch, name, model, init) -> int:
    """Every BatchNorm buffer finite and moved; returns their number."""
    stats = {k: v for k, v in model.state_dict().items() if "running_" in k}
    moved = sum(not torch.equal(v, init[k]) for k, v in stats.items())
    finite = all(torch.isfinite(v).all() for v in stats.values())
    if not finite or moved != len(stats):
        raise AssertionError(f"{name}: {moved} of {len(stats)} "
                             f"BatchNorm buffers moved, finite {finite}")
    return len(stats)


def _eval_against_cpu(torch, name, trained, test_arena, pre,
                      rows: int = 64, bf16_relative: bool = False) -> dict:
    """The trained model's eval on the card against the same weights in
    float32 on the CPU, on ``rows`` test rows through the eval preprocess
    ``pre``: in float32 on the card within 5e-3 (the flagship reference
    phase's rule: log-probs within 5e-3, and the same class wherever the
    reference's margin exceeds that), in its bf16 compute within
    ``TRANSFER_BF16_ATOL`` by the same rule (with ``bf16_relative``, that
    tolerance times the float32 log-probs' largest magnitude where it
    exceeds 1: the head's bf16 logits carry 8 bits, so a log-prob of -10.5
    rounds by up to 0.031); and its ``session_model.msgpack`` reloaded
    predicting the same classes."""
    import dataclasses

    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt

    n = min(rows, test_arena.shape[0])
    model = trained["state"].model
    model_cfg, state_dict = ckpt.load_model(trained["model_path"])
    reloaded = build_model(model_cfg, device="cuda")
    reloaded.load_state_dict(state_dict)
    f32_cfg = dataclasses.replace(model_cfg, compute_dtype="float32")
    card_f32 = build_model(f32_cfg, device="cuda")
    card_f32.load_state_dict(state_dict)
    ref_model = build_model(f32_cfg, device="cpu")
    ref_model.load_state_dict(state_dict)
    with torch.no_grad():
        x = pre(test_arena[:n])
        got = {"bf16": model(x).float().cpu(),
               "float32": card_f32(x).cpu()}
        again = reloaded(x).float().cpu()
        want = ref_model(pre(test_arena[:n].cpu()))
    reference = {}
    bf16_atol = TRANSFER_BF16_ATOL * (
        max(1.0, float(want.abs().max())) if bf16_relative else 1.0)
    for kind, atol in (("float32", 5e-3), ("bf16", bf16_atol)):
        err = float((got[kind] - want).abs().max())
        decided = (want[:, 1] - want[:, 0]).abs() > atol
        flipped = int((got[kind].argmax(1) != want.argmax(1))[decided].sum())
        if not torch.isfinite(got[kind]).all() or err > atol or flipped:
            raise AssertionError(
                f"{name} eval in {kind} on the card: max abs err {err} "
                f"against the CPU float32 forward (atol {atol}), {flipped} "
                f"of {int(decided.sum())} decided rows change class")
        reference[kind] = {"max_abs_err": err, "atol": atol,
                           "decided_rows": int(decided.sum()),
                           "class_changes": flipped}
    if not torch.equal(got["bf16"].argmax(1), again.argmax(1)):
        raise AssertionError(f"{name}: the reloaded session_model.msgpack "
                             "predicts other classes than the trained model")
    return {"reference_rows": n, "reference": reference,
            "reload_max_abs_diff": float((got["bf16"] - again).abs().max())}


def _img_s(epoch: dict) -> float:
    return epoch["steps"] * TRANSFER_BATCH / epoch["train_s"]


def phase_transfer(torch, work: str, root: str) -> dict:
    """The transfer trainer on the card (``train.classify``), at full
    width: resnet50 at 224² (2 classes, bf16 compute, adamw lr 1e-3 and
    weight decay 0.01, balanced class weights, crop + flip + ImageNet
    augmentation through the preprocess kernel, B=32, 8 steps a call, seed
    0) for 2 epochs, then 1 epoch with ``freeze_backbone``.

    It runs on the ``cli`` cohort: 2,880 rows with a Fitzpatrick type of
    3,072, light (I/II) or dark, split 70/30, training on the first
    TRANSFER_TRAIN_ROWS rows of the 70%. That cohort is DICOMs, since
    a machine without cv2 or PIL decodes no JPEG, and ``ToneTable`` (with it
    ``tone_classifier_train``) keeps only ``.jpg`` rows, the reference's
    rule; so the phase builds the port's ``LesionTable`` with the tone
    labels itself and calls ``train_classifier`` directly.

    Checks (``_classify_run``, ``_check_bn``, ``_eval_against_cpu``):
    finite losses; one preprocess-kernel launch per live train step; the
    BatchNorm buffers finite and moved in both runs, the frozen run's
    backbone bit for bit its initial one and its head trained; the step's
    preprocess call at B=32 against its plain version; the trained model's
    eval on the card against the same weights in float32 on the CPU;
    ``session_model.msgpack`` reloaded predicting the same classes; and
    (``_bn_counted``) every BatchNorm call of both runs through the fused
    kernels: 53 train forwards and 53 backwards a live step (no backward
    in the frozen run), 53 eval forwards an eval batch."""
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        make_preprocess_fn,
    )

    train_table, test_table = _tone_tables(root)
    cfg = _classify_config(os.path.join(work, "transfer"), "resnet50", 2)
    run, bn = _bn_counted(torch, "transfer", lambda: _classify_run(
        torch, train_table, test_table, cfg), backward=True)
    if bn["train_calls"] != sum(e["steps"] for e in run["epochs"]):
        raise AssertionError(f"transfer: {bn['train_calls']} train "
                             f"forwards for {run['epochs']}")
    trained, (train_arena, test_arena) = run["out"], run["arenas"]
    n_bn = _check_bn(torch, "transfer", trained["state"].model,
                     _initial_state(torch, cfg))
    kernel = _transfer_check_kernel(torch, train_arena)
    pre = make_preprocess_fn(CROP, train=False, normalize_imagenet=True,
                             layout="planar")
    evals = _eval_against_cpu(torch, "transfer", trained, test_arena, pre)
    profile = _transfer_profile(torch, trained["state"], train_arena,
                                train_table.labels)

    # frozen-backbone transfer: one epoch, the head only
    cfg_b = _classify_config(os.path.join(work, "transfer_frozen"),
                             "resnet50", 1, freeze=True)
    frozen, bn_b = _bn_counted(
        torch, "transfer frozen",
        lambda: _classify_run(torch, train_table, test_table, cfg_b),
        backward=False)
    init_b = _initial_state(torch, cfg_b)
    _check_bn(torch, "transfer frozen", frozen["out"]["state"].model, init_b)
    after = frozen["out"]["state"].model.state_dict()
    changed = [k for k, v in after.items()
               if "running_" not in k and not torch.equal(v, init_b[k])]
    if sorted(changed) != ["head.bias", "head.weight"]:
        raise AssertionError(f"frozen run changed {changed[:8]} "
                             f"({len(changed)} tensors), not the head only")

    epochs_a, epoch_b = run["epochs"], frozen["epochs"][0]
    line = {
        "phase": "transfer", "model": "resnet50", "image": CROP,
        "batch": TRANSFER_BATCH, "k": TRANSFER_K,
        "train_rows": len(train_table), "test_rows": len(test_table),
        "epochs": 2, "steps": sum(e["steps"] for e in epochs_a),
        "launches": run["launches"], "frozen_steps": epoch_b["steps"],
        "frozen_launches": frozen["launches"],
        "loss_first": float(run["losses"][0]),
        "loss_last": float(run["losses"][-1]),
        "frozen_loss_last": float(frozen["losses"][-1]),
        "bn_buffers_moved": n_bn, "frozen_changed": sorted(changed),
        "bn_launches": {"finetune": bn, "frozen": bn_b},
        "epoch_train_s": [e["train_s"] for e in epochs_a],
        "epoch_eval_s": [e["eval_s"] for e in epochs_a],
        "warm_epoch_img_per_s": _img_s(epochs_a[1]),
        "frozen_epoch_train_s": epoch_b["train_s"],
        "frozen_epoch_img_per_s": _img_s(epoch_b),
        "frozen_eval_s": epoch_b["eval_s"],
        "decode_s": run["decode_s"], "frozen_decode_s": frozen["decode_s"],
        "wall_s": run["wall"], "frozen_wall_s": frozen["wall"],
        "test_accuracy": trained["test_metrics"]["accuracy"],
        "test_auc": trained["test_metrics"].get("auc"),
        **evals, "preprocess": kernel, "profile": profile,
        "card": nvidia_smi_line(),
    }
    emit(line)
    return line


def phase_xception(torch, work: str, root: str) -> dict:
    """The HAM CLI's default model on the card: ``xception`` at full depth
    (8 middle blocks, 20.8 M parameters, 40 BatchNorms, 34 depthwise
    convs) through ``train_classifier`` at the transfer phases' operating
    point (224² crops of 256², 2 classes, bf16 compute, adamw lr 1e-3, B=32,
    8 steps a call) for 2 epochs, on the ``cli`` cohort's benign/malignant
    labels split 70/30.

    Checks: finite losses; one preprocess launch per live train step; all
    80 BatchNorm buffers finite and moved; the eval on the card against
    the same weights in float32 on the CPU on 64 test rows, by phase
    ``transfer``'s rules; the reloaded ``session_model.msgpack``
    predicting the same classes; 34 separable-conv forwards
    (``SeparableConv.calls``) in one forward, each depthwise conv through
    the depthwise kernels: 34 ``depthwise_forward`` calls a forward, 34
    ``depthwise_backward`` calls a train step (a call of
    TRANSFER_PROFILE_STEPS steps). Then that call profiled, with the device
    ms of the forward's three flows (spans ``xception.entry``, ``.middle``,
    ``.exit``) a forward, and no ATen ``conv_depthwise2d`` kernel in it."""
    from skin_image_analysis_tpu_torch.models.xception import SeparableConv
    from skin_image_analysis_tpu_torch.ops.kernels import depthwise_kernel \
        as dk
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        make_preprocess_fn,
    )

    train_table, test_table = _lesion_tables(root)
    cfg = _classify_config(os.path.join(work, "xception"), "xception", 2)
    entries = {"forward": dk.depthwise_forward,
               "backward": dk.depthwise_backward}
    before = {k: fn.launches for k, fn in entries.items()}
    run = _classify_run(torch, train_table, test_table, cfg)
    run_launches = {k: fn.launches - before[k] for k, fn in entries.items()}
    trained, (train_arena, test_arena) = run["out"], run["arenas"]
    n_bn = _check_bn(torch, "xception", trained["state"].model,
                     _initial_state(torch, cfg))
    if n_bn != 80:
        raise AssertionError(f"xception has {n_bn} BatchNorm buffers, not 80")
    pre = make_preprocess_fn(CROP, train=False, normalize_imagenet=True,
                             layout="planar")
    evals = _eval_against_cpu(torch, "xception", trained, test_arena, pre)
    SeparableConv.calls = 0
    for fn in entries.values():
        fn.launches = 0
    with torch.no_grad():
        trained["state"].model(torch.zeros(2, CROP, CROP, 3, device="cuda"),
                               train=False)
    separable = SeparableConv.calls
    if separable != 34 or dk.depthwise_forward.launches != 34:
        raise AssertionError(f"xception ran {separable} separable convs, "
                             f"{dk.depthwise_forward.launches} depthwise "
                             f"kernel forwards a forward, not 34")
    call = _transfer_call(torch, trained["state"], train_arena,
                          train_table.labels)
    for fn in entries.values():
        fn.launches = 0
    call()
    torch.cuda.synchronize()
    a_step = {k: fn.launches / TRANSFER_PROFILE_STEPS
              for k, fn in entries.items()}
    if a_step != {"forward": 34, "backward": 34}:
        raise AssertionError(f"xception's train step: depthwise kernel "
                             f"calls {a_step}, not 34 and 34")
    profile = _transfer_profile(torch, trained["state"], train_arena,
                                train_table.labels,
                                watch=("conv_depthwise2d", "depthwise3x3"))
    if (profile["kernels_named"]["conv_depthwise2d"]
            or not profile["kernels_named"]["depthwise3x3"]):
        raise AssertionError(f"xception's profiled step launched "
                             f"{profile['kernels_named']}")
    flows = {name: span["device_ms"] / span["calls"]
             for name, span in profile["spans"].items()
             if name.startswith("sia.xception.")}
    if len(flows) != 3:
        raise AssertionError(f"the profile holds the flows {sorted(flows)}")
    epochs = run["epochs"]
    line = {
        "phase": "xception", "model": "xception", "image": CROP,
        "batch": TRANSFER_BATCH, "k": TRANSFER_K,
        "parameters": sum(p.numel()
                          for p in trained["state"].model.parameters()),
        "train_rows": len(train_table), "test_rows": len(test_table),
        "epochs": cfg.epochs, "steps": sum(e["steps"] for e in epochs),
        "launches": run["launches"],
        "loss_first": float(run["losses"][0]),
        "loss_last": float(run["losses"][-1]),
        "bn_buffers_moved": n_bn,
        "separable_convs_a_forward": separable,
        "depthwise_calls_a_step": a_step,
        "depthwise_launches": run_launches,
        "flows_device_ms_a_forward": flows,
        "epoch_train_s": [e["train_s"] for e in epochs],
        "epoch_eval_s": [e["eval_s"] for e in epochs],
        "warm_epoch_img_per_s": _img_s(epochs[1]),
        "eval_img_per_s": len(test_table) / epochs[1]["eval_s"],
        "decode_s": run["decode_s"], "wall_s": run["wall"],
        "test_accuracy": trained["test_metrics"]["accuracy"],
        "test_auc": trained["test_metrics"].get("auc"),
        **evals, "profile": profile, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


# The families phase: the Keras-compatible families through the transfer
# trainer at phase transfer's operating point. efficientnet_b0 (the model
# both transfer CLIs name) trains 1 epoch; the others one 8-step call each,
# on the first FAMILY_ROWS train rows; every registered variant takes a
# 2-row eval forward at 224².
FAMILY_ROWS = TRANSFER_BATCH * TRANSFER_K
FAMILY_TEST_ROWS = 32
FAMILY_RUNS = ("resnet50_v2", "vgg16", "mobilenet_v2", "efficientnet_v2_b0")
# the variants' bf16 pooled features against float32, relative to the
# largest: at most 0.033 on an H100 (efficientnet_v2_l), 0.005-0.033
# over the 22
POOLED_RTOL = 0.1
KERAS_VARIANTS = (
    "resnet50_v2", "resnet101_v2", "resnet152_v2", "vgg16", "vgg19",
    "mobilenet_v2", *(f"efficientnet_b{i}" for i in range(8)),
    *(f"efficientnet_v2_{v}" for v in ("b0", "b1", "b2", "b3", "s", "m",
                                       "l")),
)


def _first_rows(table, n: int):
    """The first ``n`` rows of a ``LesionTable``, as a ``LesionTable``."""
    from skin_image_analysis_tpu_torch.data.dataset import LesionTable

    return LesionTable(table.metadata.take(range(min(n, len(table)))),
                       table.root_dir, class_names=table.class_names,
                       label_column=table.label_column)


def _family_run(torch, work: str, name: str, train_table, test_table,
                pre) -> dict:
    """One ``train_classifier`` run of family ``name`` for 1 epoch, under
    ``_classify_run``'s, ``_check_bn``'s and ``_eval_against_cpu``'s
    checks on ``FAMILY_TEST_ROWS`` test rows (the bf16 tolerance relative
    to the log-probs' magnitude: a barely trained resnet50_v2's eval
    log-probs reach -10.5, where bf16's ulp is 0.0625)."""
    cfg = _classify_config(os.path.join(work, name), name, 1)
    run = _classify_run(torch, train_table, test_table, cfg)
    trained = run["out"]
    n_bn = _check_bn(torch, name, trained["state"].model,
                     _initial_state(torch, cfg))
    evals = _eval_against_cpu(torch, name, trained, run["arenas"][1], pre,
                              FAMILY_TEST_ROWS, bf16_relative=True)
    epoch = run["epochs"][0]
    return {
        "parameters": sum(p.numel()
                          for p in trained["state"].model.parameters()),
        "train_rows": len(train_table), "steps": epoch["steps"],
        "launches": run["launches"], "bn_buffers_moved": n_bn,
        "loss_first": float(run["losses"][0]),
        "loss_last": float(run["losses"][-1]),
        "train_s": epoch["train_s"], "eval_s": epoch["eval_s"],
        "img_per_s": _img_s(epoch), "decode_s": run["decode_s"],
        "wall_s": run["wall"], **evals, "_run": run,
    }


def _check_variants(torch) -> dict:
    """Every registered Keras-compatible variant built on the card from a
    seed, and a 2-row eval forward at 224² in bf16 held against the same
    weights' float32 forward on the card: finite, within
    ``TRANSFER_BF16_ATOL`` of it relative to the float32 log-probs'
    largest magnitude (at least 1: a random net's eval logits run large,
    and bf16 carries 8 bits of them), the same class wherever the
    float32 margin exceeds that tolerance, and the pooled features (the
    head's input) within ``POOLED_RTOL`` of the float32 ones relative to
    their largest. At init an EfficientNet's eval signal fades through
    its squeeze-excite gates (pooled features near 1e-7, log-probs at
    -ln 2 to 7 digits), so the pooled features carry that check."""
    import dataclasses

    from skin_image_analysis_tpu_torch.config import ModelConfig
    from skin_image_analysis_tpu_torch.models.cnn import build_model

    g = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((2, CROP, CROP, 3), device="cuda", generator=g)
    out = {}
    for name in KERAS_VARIANTS:
        t = time.perf_counter()
        cfg = ModelConfig(name=name, image_size=CROP)
        model = build_model(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))
        f32 = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                          device="cuda")
        f32.load_state_dict(model.state_dict())
        feats = []
        hooks = [m.head.register_forward_pre_hook(
            lambda _, args: feats.append(args[0].float()))
            for m in (model, f32)]
        with torch.no_grad():
            got, want = model(x).float(), f32(x)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        feat_err = float((feats[0] - feats[1]).abs().max()
                         / feats[1].abs().max())
        err = float((got - want).abs().max())
        tol = TRANSFER_BF16_ATOL * max(1.0, float(want.abs().max()))
        decided = (want[:, 1] - want[:, 0]).abs() > tol
        flipped = int((got.argmax(1) != want.argmax(1))[decided].sum())
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()) \
                or err > tol or flipped or not feat_err <= POOLED_RTOL:
            raise AssertionError(
                f"{name} on the card: bf16 eval log-probs {got.tolist()} "
                f"against float32 {want.tolist()} (max abs err {err}, tol "
                f"{tol}, {flipped} decided rows change class); pooled "
                f"features {feat_err} apart relative to their largest "
                f"(tol {POOLED_RTOL})")
        out[name] = {"parameters": sum(p.numel() for p in model.parameters()),
                     "max_abs_err": err, "tol": tol,
                     "pooled_rel_err": feat_err,
                     "pooled_max_abs": float(feats[1].abs().max()),
                     "max_abs_log_prob": float(want.abs().max()),
                     "s": time.perf_counter() - t}
        del model, f32
    torch.cuda.empty_cache()
    return out


def phase_families(torch, work: str, root: str) -> dict:
    """The Keras-compatible families on the card, through
    ``train_classifier`` at phase ``transfer``'s operating point (224²
    crops of 256², 2 classes, bf16 compute, adamw lr 1e-3, B=32, 8 steps a
    call, random weights from seed 0) on the ``cli`` cohort's tone labels:

    - efficientnet_b0 at full depth for 1 epoch: finite losses, one
      preprocess launch per live train step, every BatchNorm buffer finite
      and moved, the eval on the card against the same weights in float32
      on the CPU on 32 test rows by phase ``transfer``'s rules, the
      reloaded ``session_model.msgpack`` predicting the same classes; then
      one TRANSFER_PROFILE_STEPS-step call profiled (device kernels a
      step, busy share, device ms by group, the depthwise convs a group
      of their own);
    - resnet50_v2, vgg16, mobilenet_v2 and efficientnet_v2_b0 at full
      depth, one 8-step call each (the first 256 train rows, 1 epoch)
      under the same checks;
    - every one of the 22 registered variants (``_check_variants``)."""
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        make_preprocess_fn,
    )

    t0 = time.perf_counter()
    train_table, test_table = _tone_tables(root)
    test_rows = _first_rows(test_table, FAMILY_TEST_ROWS)
    pre = make_preprocess_fn(CROP, train=False, normalize_imagenet=True,
                             layout="planar")
    b0 = _family_run(torch, work, "efficientnet_b0", train_table, test_rows,
                     pre)
    run = b0.pop("_run")
    b0["profile"] = _transfer_profile(torch, run["out"]["state"],
                                      run["arenas"][0], train_table.labels)
    del run
    runs = {}
    short = _first_rows(train_table, FAMILY_ROWS)
    for name in FAMILY_RUNS:
        runs[name] = _family_run(torch, work, name, short, test_rows, pre)
        runs[name].pop("_run")
    variants = _check_variants(torch)
    line = {
        "phase": "families", "image": CROP, "batch": TRANSFER_BATCH,
        "k": TRANSFER_K, "efficientnet_b0": b0, "runs": runs,
        "variants": variants,
        "launches": b0["launches"] + sum(r["launches"]
                                         for r in runs.values()),
        "seconds": time.perf_counter() - t0, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


# The explain phase: the explain CLI's attribution step on the cli phase's
# flagship folder (its first EXPLAIN_IMAGES test crops at 224², bf16),
# every method at EXPLAIN_STEPS steps. The CPU references (float32) take
# IG at EXPLAIN_CPU_STEPS steps and occlusion on the first
# EXPLAIN_CPU_ROWS images, to keep the phase under a minute.
EXPLAIN_IMAGES, EXPLAIN_STEPS = 6, 200
EXPLAIN_CPU_STEPS, EXPLAIN_CPU_ROWS = 16, 2
# float32 on the card (TF32 off) against float32 on the CPU: the cosine
# of the flattened attributions, and the share of elements off by more
# than 1e-3 of the reference's largest magnitude (a near-tied max-pool
# window or a ReLU at zero routes an input gradient to another pixel; on
# an H100 80GB HBM3 at 700 W: cosines of 0.9999973 and more, shares of
# 0.0012 and less, and saliency's largest elementwise gap at 0.074 of its
# largest magnitude); the folder's bf16 compute against the same: the
# cosine (0.982 and more on that card)
EXPLAIN_F32_COS, EXPLAIN_F32_OFF, EXPLAIN_BF16_COS = 0.9999, 0.01, 0.95
# the four families of phase explain's Grad-CAM: (name, model folder under
# the phases' working directory, or None for a model built from seed 0)
CAM_FAMILIES = (("resnet50", "transfer"), ("xception", "xception"),
                ("efficientnet_b0", "efficientnet_b0"),
                ("mobilenet_v2", None))


def _cosine(got, want) -> float:
    a = got.detach().double().cpu().flatten()
    b = want.detach().double().cpu().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def _held(torch, name, card32, card16, cpu32) -> dict:
    """An attribution on the card in float32 and in bf16 against the CPU's
    float32, by the rules of EXPLAIN_F32_COS, EXPLAIN_F32_OFF and
    EXPLAIN_BF16_COS; the largest elementwise gap reported."""
    diff = (card32.detach().float().cpu() - cpu32.detach().float()).abs()
    largest = cpu32.abs().max().clamp_min(1e-30)
    out = {"float32_cosine": _cosine(card32, cpu32),
           "float32_off_share": float((diff > 1e-3 * largest).float()
                                      .mean()),
           "float32_rel_err": float(diff.max() / largest),
           "bf16_cosine": _cosine(card16, cpu32)}
    finite = all(bool(torch.isfinite(t).all())
                 for t in (card32, card16, cpu32))
    if not finite or out["float32_cosine"] < EXPLAIN_F32_COS \
            or out["float32_off_share"] > EXPLAIN_F32_OFF \
            or out["bf16_cosine"] < EXPLAIN_BF16_COS:
        raise AssertionError(
            f"explain {name}: {out} against float32 cosine "
            f"{EXPLAIN_F32_COS} and share {EXPLAIN_F32_OFF}, bf16 cosine "
            f"{EXPLAIN_BF16_COS}; all finite {finite}")
    return out


def _models(torch, model_cfg, state_dict):
    """(bf16 on the card, float32 on the card, float32 on the CPU) of the
    same weights; the first at the folder's own compute dtype."""
    import dataclasses

    from skin_image_analysis_tpu_torch.models.cnn import build_model

    f32 = dataclasses.replace(model_cfg, compute_dtype="float32")
    out = []
    for cfg, dev in ((model_cfg, "cuda"), (f32, "cuda"), (f32, "cpu")):
        m = build_model(cfg, device=dev)
        m.load_state_dict(state_dict)
        out.append(m.eval())
    return out


def _family_cam(torch, name: str, path, x) -> dict:
    """``grad_cam_gap_head`` of one family at 224² on the card (bf16 and
    float32) against the float32 CPU CAM, through ``_held``; the
    closed-form head on the map ``features`` returns giving back the
    float32 model's log-probs on the card within 1e-4 (the bf16 model's
    gap reported); the bf16 CAM's time."""
    from skin_image_analysis_tpu_torch.config import ModelConfig
    from skin_image_analysis_tpu_torch.explain.attribution import (
        gap_head_log_probs,
        grad_cam_gap_head,
    )
    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt

    if path is None:
        model_cfg = ModelConfig(name=name, image_size=CROP)
        state_dict = build_model(
            model_cfg, device="cpu",
            generator=torch.Generator().manual_seed(0)).state_dict()
    else:
        model_cfg, state_dict = ckpt.load_model(path)
    card16, card32, cpu32 = _models(torch, model_cfg, state_dict)
    with torch.no_grad():
        preds = card16(x).argmax(1)
        head = {}
        for kind, m in (("float32", card32), ("bf16", card16)):
            head[kind] = float((gap_head_log_probs(m, m.features(x))
                                - m(x).float()).abs().max())
    if head["float32"] > 1e-4:
        raise AssertionError(f"{name}: the head on the captured map is "
                             f"{head['float32']} from the model's log-probs")
    cams = [grad_cam_gap_head(m, xx, pp) for m, xx, pp in (
        (card32, x, preds), (card16, x, preds),
        (cpu32, x.cpu(), preds.cpu()))]
    torch.cuda.synchronize()
    t = time.perf_counter()
    grad_cam_gap_head(card16, x, preds)
    torch.cuda.synchronize()
    return {"map": list(cams[0].shape[1:]), **_held(torch, name, *cams),
            "head_max_abs_diff": head, "bf16_ms": 1e3 * (time.perf_counter()
                                                        - t)}


def phase_explain(torch, work: str, ctx: dict) -> dict:
    """The explain path on the card (the explain CLI's attribution step,
    ``tone_bias_explain.explain``) on the cli phase's flagship folder: its
    first EXPLAIN_IMAGES test crops at 224², at the folder's bf16 compute.

    - Every method with ``--bench``: EXPLAIN_STEPS steps for IG and
      GradientShap (8 baselines of EXPLAIN_STEPS steps), one cold and
      three warm calls; finite attributions of the input's shape.
    - IG's completeness on the card in float32 at EXPLAIN_STEPS steps:
      the sum of each image's attribution within rtol 0.05, atol 5e-3 of
      f(x) - f(0) (the JAX package's tolerance); the bf16 model's gap
      reported.
    - Saliency, IG (EXPLAIN_CPU_STEPS steps), occlusion (the first
      EXPLAIN_CPU_ROWS images) and Grad-CAM, as the CLI computes them, on
      the card in float32 and in bf16 against float32 on the CPU
      (``_held``).
    - ``grad_cam_gap_head`` on resnet50 (phase transfer), xception (phase
      xception), efficientnet_b0 (phase families) and a mobilenet_v2
      from seed 0 (``_family_cam``), on the same images ImageNet-
      normalized.
    - The figures: without matplotlib, the explain CLI, the test CLI's
      ``--grid`` and the analysis plots raise an ImportError naming it;
      with it, they write their files. The analysis aggregate of the cli
      phase's results directory either way."""
    import contextlib
    import importlib.util
    import io

    import numpy as np

    from skin_image_analysis_tpu_torch.analysis import read_experiments
    from skin_image_analysis_tpu_torch.analysis.plots import plot_di_figure
    from skin_image_analysis_tpu_torch.cli import tone_bias_analysis
    from skin_image_analysis_tpu_torch.cli import tone_bias_explain as cli
    from skin_image_analysis_tpu_torch.cli import tone_bias_test
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    folder, root = ctx["folder"], ctx["root224"]
    methods = {}
    for method in cli.METHODS:
        out = cli.explain(root, folder, method, EXPLAIN_IMAGES,
                          EXPLAIN_STEPS, bench=True)
        if not np.isfinite(out.attributions).all() or \
                out.attributions.shape[:3] != out.images.shape[:3]:
            raise AssertionError(f"explain {method}: attributions of shape "
                                 f"{out.attributions.shape}")
        methods[method] = {k: out.bench[k] for k in (
            "compile_s", "s_per_batch", "img_per_min", "steps")}
    bench_s = time.perf_counter() - t0

    batch = cli.load_batch(root, folder, EXPLAIN_IMAGES)
    card16, card32, cpu32 = _models(
        torch, *ckpt.load_model(os.path.join(folder, ckpt.MODEL_FILENAME)))
    x, preds = batch.x, cli.predict(batch.model, batch.x)[0]

    # IG completeness at EXPLAIN_STEPS steps
    complete = {}
    for kind, m in (("float32", card32), ("bf16", card16)):
        ig = cli.attribute(m, x, preds, "ig", EXPLAIN_STEPS)
        with torch.no_grad():
            f = [m(v).float().gather(1, preds[:, None])[:, 0]
                 for v in (x, torch.zeros_like(x))]
        want, total = f[0] - f[1], ig.sum(dim=(1, 2, 3))
        gap = (total - want).abs()
        complete[kind] = {
            "max_abs_gap": float(gap.max()),
            "within": bool((gap <= 5e-3 + 0.05 * want.abs()).all()),
            "f_x_minus_f_0": want.cpu().tolist()}
    if not complete["float32"]["within"]:
        raise AssertionError(f"IG completeness on the card: {complete}")

    held = {}
    for method, steps, rows in (("saliency", 1, EXPLAIN_IMAGES),
                                ("ig", EXPLAIN_CPU_STEPS, EXPLAIN_IMAGES),
                                ("occlusion", 1, EXPLAIN_CPU_ROWS),
                                ("gradcam", 1, EXPLAIN_IMAGES)):
        xs, ps = x[:rows], preds[:rows]
        got = [cli.attribute(m, xx, pp, method, steps) for m, xx, pp in (
            (card32, xs, ps), (card16, xs, ps),
            (cpu32, xs.cpu(), ps.cpu()))]
        held[method] = {"rows": rows, **_held(torch, method, *got)}

    mean = torch.tensor(IMAGENET_MEAN, device="cuda")
    std = torch.tensor(IMAGENET_STD, device="cuda")
    x_imagenet = (batch.images - mean) / std
    families = {}
    for name, sub in CAM_FAMILIES:
        path = None if sub is None else os.path.join(work, sub,
                                                     ckpt.MODEL_FILENAME)
        families[name] = _family_cam(torch, name, path, x_imagenet)

    has_mpl = importlib.util.find_spec("matplotlib") is not None
    results = os.path.dirname(folder)
    agg = read_experiments(results, "balanced")
    if agg["n_runs"] != 1 or len(agg["epochs"]) != 3:
        raise AssertionError(f"analysis of {results}: {agg['n_runs']} runs, "
                             f"{len(agg['epochs'])} epochs")
    grid = os.path.join(work, "grid.png")
    figures = (
        lambda: cli.main([root, folder, "--method", "gradcam"]),
        lambda: tone_bias_test.main([root, folder, "--grid", grid]),
        lambda: tone_bias_analysis.main(["balanced", "2",
                                         "--experiments-dir", results]),
        lambda: plot_di_figure(agg, "balanced", save_dir=work))
    for draw in figures:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                draw()
        except ImportError as e:
            if has_mpl or "matplotlib" not in str(e):
                raise
        else:
            if not has_mpl:
                raise AssertionError("a figure drawn without matplotlib")
    if has_mpl and (len(os.listdir(os.path.join(folder, "explain")))
                    != EXPLAIN_IMAGES or not os.path.exists(grid)):
        raise AssertionError("the explain CLI or --grid wrote no figures")

    line = {
        "phase": "explain", "model": batch.model_cfg.name, "image": CROP,
        "images": EXPLAIN_IMAGES, "methods": methods,
        "ig_completeness": complete, "held_against_cpu": held,
        "tolerances": {"float32_cosine": EXPLAIN_F32_COS,
                       "float32_off_share": EXPLAIN_F32_OFF,
                       "bf16_cosine": EXPLAIN_BF16_COS},
        "grad_cam_gap_head": families, "matplotlib": has_mpl,
        "analysis_epochs": len(agg["epochs"]), "bench_s": bench_s,
        "seconds": time.perf_counter() - t0, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


# The serve phase: the cli phase's flagship folder (224², bf16) behind the
# port's HTTP server, SERVE_CLIENTS concurrent clients of SERVE_REQUESTS raw
# /predict requests each over keep-alive connections, one /predict_batch of
# SERVE_MAX_BATCH rows, and both exports. Every answer is held against a
# float32 CPU forward of the same checkpoint by phase families' bf16 rule.
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_MAX_BATCH = 32, 8, 64
SERVE_RELOAD_CLIENTS, SERVE_RELOAD_REQUESTS = 8, 4


def _serve_pixels(folder: str, root224: str, n: int):
    """``n`` test crops of ``folder`` (its test rows in order, again from
    the first where it has fewer), uint8 NHWC."""
    from skin_image_analysis_tpu_torch.data.dataset import LesionTable
    from skin_image_analysis_tpu_torch.data.ingest import read_csv
    from skin_image_analysis_tpu_torch.data.loader import HostImageStore
    from skin_image_analysis_tpu_torch.train import loop

    test = read_csv(os.path.join(folder, loop.TEST_SET_FILENAME),
                    index_col=True)
    table = LesionTable(test.take([i % len(test) for i in range(n)]),
                        root224)
    return HostImageStore(table, CROP).images.transpose(0, 2, 3, 1).copy()


def _cpu_log_probs(torch, folder: str, px):
    """The folder's inference program in float32 on the CPU over ``px``."""
    import dataclasses

    import numpy as np

    from skin_image_analysis_tpu_torch.cli._common import input_convention
    from skin_image_analysis_tpu_torch.serve.export import build_infer_fn
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt

    model_cfg, state_dict = ckpt.load_model(os.path.join(
        folder, ckpt.MODEL_FILENAME))
    norm, affine = input_convention(folder)
    program = build_infer_fn(
        dataclasses.replace(model_cfg, compute_dtype="float32"), state_dict,
        normalize_imagenet=norm, input_affine=affine, device="cpu")
    with torch.inference_mode():
        return np.concatenate([
            program(torch.from_numpy(px[i:i + 64]))["log_probs"].numpy()
            for i in range(0, len(px), 64)])


def _held_answers(np, name: str, log_probs, pred, want,
                  column: int | None = None) -> dict:
    """Answers on the card (bf16) against the float32 CPU forward
    ``want``: within TRANSFER_BF16_ATOL times the reference's largest
    magnitude where it exceeds 1 (phase families' rule), and the same
    class wherever the reference's margin is at least that. With
    ``column``, ``log_probs`` holds that column only."""
    log_probs, pred = np.asarray(log_probs), np.asarray(pred)
    ref = want if column is None else want[:, column]
    tol = TRANSFER_BF16_ATOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(log_probs - ref).max())
    margin = np.abs(want[:, 1] - want[:, 0])
    flipped = int(((pred != want.argmax(1)) & (margin >= tol)).sum())
    if not np.isfinite(log_probs).all() or err > tol or flipped \
            or log_probs.shape != ref.shape:
        raise AssertionError(f"serve {name}: max abs err {err} against the "
                             f"CPU float32 forward (tol {tol}), {flipped} "
                             f"decided rows change class")
    return {"rows": len(want), "max_abs_err": err, "tol": tol,
            "near_ties": int((margin < tol).sum()), "class_changes": flipped}


def _http(base: str, path: str, data: bytes | None = None,
          ctype: str = "application/octet-stream") -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, data=data, headers={"Content-Type": ctype},
        method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _clients(base: str, px, clients: int, requests: int):
    """``clients`` threads, each ``requests`` raw /predict posts on one
    keep-alive connection, all started together; returns (answers by
    image, latencies in s, wall s)."""
    import http.client
    import threading

    host, port = base.removeprefix("http://").split(":")
    answers, latencies, errors = {}, [], []
    start = threading.Barrier(clients + 1)

    def client(c):
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        try:
            start.wait()
            for j in range(requests):
                i = c * requests + j
                t = time.perf_counter()
                conn.request("POST", "/predict", px[i].tobytes(),
                             {"Content-Type": "application/octet-stream"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                latencies.append(time.perf_counter() - t)
                if resp.status != 200:
                    raise AssertionError(f"/predict {resp.status}: {body}")
                answers[i] = body
        except BaseException as e:
            errors.append(e)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or len(answers) != clients * requests:
        raise AssertionError(f"serve clients: {len(answers)} answers, "
                             f"errors {errors[:3]}")
    return answers, latencies, wall


def _reload_folder(torch, work: str, folder: str) -> tuple[str, str]:
    """A same-architecture flagship folder to reload: the elastic phase's,
    when its ModelConfig and input convention equal ``folder``'s; else a
    copy of ``folder`` with its weights perturbed, saved through
    ``save_model``. Returns (folder, which)."""
    from skin_image_analysis_tpu_torch.cli._common import input_convention
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt

    cfg, state_dict = ckpt.load_model(os.path.join(folder,
                                                   ckpt.MODEL_FILENAME))
    results = os.path.join(work, "elastic", "results")
    for name in sorted(os.listdir(results)) if os.path.isdir(results) else []:
        elastic = os.path.join(results, name)
        if ckpt.load_model(os.path.join(elastic, ckpt.MODEL_FILENAME))[0] \
                == cfg and input_convention(elastic) \
                == input_convention(folder):
            return elastic, "elastic"
    copy = os.path.join(work, "serve_perturbed")
    shutil.copytree(folder, copy)
    gen = torch.Generator().manual_seed(14)
    ckpt.save_model(os.path.join(copy, ckpt.MODEL_FILENAME), cfg, {
        k: v + 0.01 * v.std() * torch.randn(v.shape, generator=gen)
        if v.is_floating_point() and v.numel() > 1 else v
        for k, v in state_dict.items()})
    return copy, "perturbed copy"


def phase_serve(torch, work: str, ctx: dict) -> dict:
    """The port's serving path on the card (``serve/``) on the cli phase's
    flagship folder (224², bf16).

    - ``InferenceSession.from_experiment(folder, max_batch=64)``: each
      bucket of the ladder 1..64 run once cold and once warm, timed.
    - ``make_http_server`` on port 0 in a thread: SERVE_CLIENTS
      concurrent clients of SERVE_REQUESTS raw ``/predict`` requests each
      (req/s, p50 and p95 latency, coalesced batches); one 64-row
      ``/predict_batch`` (img/s); a PNG ``/predict`` where cv2 or PIL
      imports. Every answer held against a float32 CPU forward of the
      checkpoint (``_held_answers``).
    - ``/reload`` of a same-architecture flagship folder (``_reload_folder``)
      serving that checkpoint's answers; ``/reload`` of the transfer
      phase's resnet50 folder answering 409 with every served tensor and
      the answers bit for bit as before; ``/healthz`` and ``/stats``.
    - ``export_model`` on the card of the flagship folder and the transfer
      resnet50 folder, each artifact served through ``from_artifact`` at
      64 rows and n = 1 against the folder session.
    - No kernel of the port launches on this path: the wrappers' counts
      are the same before and after."""
    import importlib.util
    import threading

    import numpy as np

    from skin_image_analysis_tpu_torch.ops.kernels.convblock_kernel import (
        fused_phase_conv0_dw,
        fused_phase_conv0_fwd,
    )
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.serve.export import export_model
    from skin_image_analysis_tpu_torch.serve.server import (
        DynamicBatcher,
        InferenceSession,
        make_http_server,
    )
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    wrappers = (fused_preprocess_planar, fused_phase_conv0_fwd,
                fused_phase_conv0_dw)
    launches_before = [w.launches for w in wrappers]
    folder, transfer = ctx["folder"], os.path.join(work, "transfer")
    n_req = SERVE_CLIENTS * SERVE_REQUESTS
    px = _serve_pixels(folder, ctx["root224"], n_req)
    want = _cpu_log_probs(torch, folder, px)

    t = time.perf_counter()
    sess = InferenceSession.from_experiment(folder,
                                            max_batch=SERVE_MAX_BATCH)
    session_s = time.perf_counter() - t
    ladder = {}
    for b in sess.buckets:
        zeros = np.zeros((b, CROP, CROP, 3), np.uint8)
        times = []
        for _ in range(2):
            t = time.perf_counter()
            sess._run_bucket(zeros)
            times.append((time.perf_counter() - t) * 1e3)
        ladder[b] = {"first_ms": times[0], "warm_ms": times[1]}

    batcher = DynamicBatcher(sess, window_ms=2.0).start()
    server = make_http_server(batcher, port=0, reload_any=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        answers, lat, wall = _clients(base, px, SERVE_CLIENTS,
                                      SERVE_REQUESTS)
        stats = _http(base, "/stats")[1]
        if stats["max_coalesced"] < 2 or stats["requests"] != n_req:
            raise AssertionError(f"serve: no coalescing under "
                                 f"{SERVE_CLIENTS} clients: {stats}")
        held = {"predict": _held_answers(
            np, "predict", [answers[i]["log_probs"] for i in range(n_req)],
            [answers[i]["pred"] for i in range(n_req)], want)}

        batch = px[:SERVE_MAX_BATCH].tobytes()
        _http(base, "/predict_batch", batch)
        t = time.perf_counter()
        code, got = _http(base, "/predict_batch", batch)
        batch_s = time.perf_counter() - t
        if code != 200:
            raise AssertionError(f"/predict_batch {code}: {got}")
        # it answers p_malignant, the malignant column's exp
        held["predict_batch"] = _held_answers(
            np, "predict_batch",
            np.log(np.maximum(np.asarray(got["p_malignant"]), 1e-38)),
            got["pred"], want[:SERVE_MAX_BATCH], column=1)

        decoder = next((m for m in ("cv2", "PIL")
                        if importlib.util.find_spec(m)), None)
        if decoder is not None:
            if decoder == "cv2":
                import cv2

                png = cv2.imencode(".png", px[0][:, :, ::-1])[1].tobytes()
            else:
                import io

                from PIL import Image

                buf = io.BytesIO()
                Image.fromarray(px[0]).save(buf, format="PNG")
                png = buf.getvalue()
            code, got = _http(base, "/predict", png, "image/png")
            if code != 200:
                raise AssertionError(f"PNG /predict {code}: {got}")
            held["png"] = _held_answers(np, "png", [got["log_probs"]],
                                        [got["pred"]], want[:1])

        # /reload: a same-architecture folder serves its checkpoint
        other, which = _reload_folder(torch, work, folder)
        n_rel = SERVE_RELOAD_CLIENTS * SERVE_RELOAD_REQUESTS
        want_other = _cpu_log_probs(torch, other, px[:n_rel])
        t = time.perf_counter()
        code, info = _http(base, "/reload", json.dumps(
            {"folder": other}).encode(), "application/json")
        reload_s = time.perf_counter() - t
        if code != 200 or info["reloads"] != 1:
            raise AssertionError(f"/reload {other}: {code} {info}")
        after, _, _ = _clients(base, px, SERVE_RELOAD_CLIENTS,
                               SERVE_RELOAD_REQUESTS)
        held["reloaded"] = _held_answers(
            np, "reloaded", [after[i]["log_probs"] for i in range(n_rel)],
            [after[i]["pred"] for i in range(n_rel)], want_other)
        moved = float(np.abs(np.asarray(
            [after[i]["log_probs"] for i in range(n_rel)])
            - [answers[i]["log_probs"] for i in range(n_rel)]).max())

        # /reload of another architecture: 409, nothing touched
        served = {k: v.clone() for k, v in sess._weights.items()}
        before = _http(base, "/predict_batch", batch)
        code, refused = _http(base, "/reload", json.dumps(
            {"folder": transfer}).encode(), "application/json")
        again = _http(base, "/predict_batch", batch)
        untouched = all(torch.equal(v, served[k])
                        for k, v in sess._weights.items())
        if code != 409 or not untouched or again != before:
            raise AssertionError(f"/reload resnet50: {code} {refused}, "
                                 f"weights untouched {untouched}, answers "
                                 f"same {again == before}")

        health = _http(base, "/healthz")[1]
        stats = _http(base, "/stats")[1]
        if health["status"] != "ok" or health["reloads"] != 1 \
                or health["compiled_buckets"] != sess.buckets \
                or health["source"] != folder or stats["rss_kb"] <= 0:
            raise AssertionError(f"/healthz {health}, /stats {stats}")
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()

    exports = {}
    for name, src in (("flagship", folder), ("resnet50", transfer)):
        out = os.path.join(work, f"serve_{name}.pt2")
        torch.cuda.synchronize()
        t = time.perf_counter()
        manifest = export_model(src, out)
        export_s = time.perf_counter() - t
        art = InferenceSession.from_artifact(out, max_batch=SERVE_MAX_BATCH)
        ref = InferenceSession.from_experiment(src,
                                               max_batch=SERVE_MAX_BATCH)
        # both ladders warm, so that each n runs at the same bucket in both
        art.warm()
        ref.warm()
        deltas = {}
        for n in (SERVE_MAX_BATCH, 1):
            got, exp = art.predict(px[:n]), ref.predict(px[:n])
            deltas[n] = float(np.abs(got["log_probs"]
                                     - exp["log_probs"]).max())
            if deltas[n] > 1e-5 or not np.array_equal(got["pred"],
                                                      exp["pred"]):
                raise AssertionError(f"export {name} at n={n}: max "
                                     f"|dlog_probs| {deltas[n]}")
        exports[name] = {
            "export_s": export_s, "mb": manifest["bytes"] / 1e6,
            "batch": manifest["input"]["shape"][0],
            "batch_range": manifest["batch_range"],
            "platforms": manifest["platforms"],
            "artifact_buckets": art.buckets,
            "max_abs_dlog_probs_vs_folder": {
                str(n): d for n, d in deltas.items()},
        }

    launches = [w.launches - n for w, n in zip(wrappers, launches_before)]
    if any(launches):
        raise AssertionError(f"the serve path launched kernels: {launches}")
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    line = {
        "phase": "serve", "model": ckpt.load_model(os.path.join(
            folder, ckpt.MODEL_FILENAME))[0].name, "image": CROP,
        "max_batch": SERVE_MAX_BATCH, "buckets": sess.buckets,
        "session_s": session_s, "ladder_ms": ladder,
        "clients": SERVE_CLIENTS, "requests": n_req,
        "req_per_s": n_req / wall, "p50_ms": float(np.percentile(lat_ms, 50)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "batches": stats["batches"], "max_coalesced": stats["max_coalesced"],
        "predict_batch_img_per_s": SERVE_MAX_BATCH / batch_s,
        "png_decoder": decoder, "held_against_cpu": held,
        "reload_folder": which, "reload_s": reload_s,
        "reload_max_abs_change": moved,
        "refused_reload": refused["error"][:60],
        "exports": exports, "kernel_launches": launches,
        "seconds": time.perf_counter() - t0, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


# The quantize phase: the cli phase's folder quantized to int8 with the JAX
# CLI's default calibration (the first 256 rows of session_train.csv, max
# mode), served over HTTP like phase serve, and both int8 exports.
QUANT_CALIB_ROWS = 256
# the int8 program on the card against the same tree on the CPU, and over
# HTTP against its own batch call: float accumulation order and batch
# shape move a log-prob by about 1e-3 (9.8e-4 and 3.8e-4 measured on an
# H100); calibration on zero-filled rows moves the mean by 1.9e-2
QUANT_ATOL = 5e-3
# int8 against the float32 graph: the mean |dlog p| within QUANT_DLOGP
# (7.7e-4 measured; a constant log(1/2) answer is 1.9e-2 off on this
# folder), and every row whose float margin is at least QUANT_MARGIN
# keeps its class (the folder's median margin is 0.038)
QUANT_DLOGP = 5e-3
QUANT_MARGIN = 0.02
# one percentile:99.9 calibration on the same rows (all of them in one
# forward, every tap sorted whole): its mean |dlog p| against the float32
# graph must beat the constant log(1/2) answer's distance on this folder
QUANT_PERCENTILE, QUANT_CONSTANT_DLOGP = "percentile:99.9", 1.9e-2


def _percentile_calibration(torch, q, model_cfg, state_dict, calib,
                            report, graph) -> dict:
    """``quantize_model`` in QUANT_PERCENTILE mode on the card: seconds,
    peak device memory over the call, and the fidelity report against
    the float32 graph on the report rows."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = time.perf_counter()
    tree = q.quantize_model(model_cfg, state_dict, calib,
                            calib_mode=QUANT_PERCENTILE, device="cuda",
                            graph=graph)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    fidelity = q.quantization_report(model_cfg, state_dict, tree, report,
                                     device="cuda", graph=graph)
    if not all(math.isfinite(v) for v in fidelity.values()) \
            or not fidelity["mean_abs_dlogp"] < QUANT_CONSTANT_DLOGP:
        raise AssertionError(f"quantize {QUANT_PERCENTILE}: fidelity "
                             f"{fidelity} (a constant answer is "
                             f"{QUANT_CONSTANT_DLOGP} off)")
    return {"calib_mode": QUANT_PERCENTILE, "rows": len(calib),
            "seconds": secs, "peak_gb": peak / 1e9,
            "peak_over_start_gb": (peak - base) / 1e9,
            "fidelity": fidelity,
            "bound_mean_abs_dlogp": QUANT_CONSTANT_DLOGP}


def _calib_root(work: str, folder: str, n: int) -> str:
    """The 224² centre crops of the cohort's first ``n`` train rows and
    ``n`` test rows of ``folder``, as DICOMs in a root of their own (the
    card's machine decodes DICOMs only at their own size)."""
    from skin_image_analysis_tpu_torch.data.dicom import read_dicom_image
    from skin_image_analysis_tpu_torch.data.ingest import read_csv

    src, out = os.path.join(work, "cohort"), os.path.join(work, "c224q")
    os.makedirs(out, exist_ok=True)
    lo = (SIZE - CROP) // 2
    for split in ("session_train.csv", "session_test.csv"):
        ids = read_csv(os.path.join(folder, split),
                       index_col=True).column("isic_id")[:n]
        for isic_id in ids:
            img = read_dicom_image(os.path.join(src, f"{isic_id}.dcm"))
            with open(os.path.join(out, f"{isic_id}.dcm"), "wb") as f:
                f.write(_dicom_rgb(img[lo:lo + CROP, lo:lo + CROP].copy()))
    return out


def _quant_held(np, name: str, got, want, atol: float) -> dict:
    """Log-probs ``got`` against ``want``: within ``atol`` and the same
    class wherever ``want``'s margin is at least ``atol``."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    margin = np.abs(want[:, 1] - want[:, 0])
    flipped = int(((got.argmax(1) != want.argmax(1))
                   & (margin >= atol)).sum())
    if not np.isfinite(got).all() or err > atol or flipped \
            or got.shape != want.shape:
        raise AssertionError(f"quantize {name}: max |dlog p| {err} (atol "
                             f"{atol}), {flipped} decided rows change class")
    return {"rows": len(want), "max_abs_err": err, "atol": atol,
            "class_changes": flipped}


def phase_quantize(torch, work: str, ctx: dict) -> dict:
    """The port's int8 serving path on the card (``serve/quantize.py``,
    ``serve/trace.py``) on the cli phase's flagship folder (224², bf16).

    - One QUANT_PERCENTILE calibration on the same 256 rows
      (``_percentile_calibration``: seconds, peak memory, fidelity).
    - ``calibration_rows`` (the JAX CLI's default: 256 rows of the
      folder's train split, report rows from its test split) and
      ``InferenceSession.from_experiment_quantized`` (max calibration),
      timed; the fidelity report (``quantization_report``: the int8
      program against the float32 graph on the report rows; its mean
      |dlog p| within QUANT_DLOGP, and no row of float margin
      QUANT_MARGIN or more changing class, of which there must be some)
      and the int8 answers against the float session's (bf16) on the
      same rows.
    - The int8 program on the card against the same tree on the CPU
      (``QUANT_ATOL``).
    - The int8 session behind ``make_http_server``: SERVE_CLIENTS x
      SERVE_REQUESTS raw ``/predict`` requests (req/s, p50, p95), every
      answer held against the session's own batch call (``QUANT_ATOL``).
    - ``export_model(quantize="int8")`` and ``"int8-weights"``: each
      artifact served through ``from_artifact`` against the int8 session
      (int8) or the in-process weight-only program (int8-weights).
    - The captured graph and the int8 op list written as JSON lines
      (``write_graph_jsonl``) and read back: one record per op, in order.
    - No kernel of the port launches on this path."""
    import threading

    import numpy as np

    from skin_image_analysis_tpu_torch.ops.kernels.convblock_kernel import (
        fused_phase_conv0_dw,
        fused_phase_conv0_fwd,
    )
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.serve import quantize as q
    from skin_image_analysis_tpu_torch.serve import trace
    from skin_image_analysis_tpu_torch.serve.export import export_model
    from skin_image_analysis_tpu_torch.serve.server import (
        DynamicBatcher,
        InferenceSession,
        make_http_server,
    )
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    wrappers = (fused_preprocess_planar, fused_phase_conv0_fwd,
                fused_phase_conv0_dw)
    launches_before = [w.launches for w in wrappers]
    folder = ctx["folder"]
    model_cfg, state_dict = ckpt.load_model(os.path.join(
        folder, ckpt.MODEL_FILENAME))
    t = time.perf_counter()
    root = _calib_root(work, folder, QUANT_CALIB_ROWS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        calib, report, report_is_calib = q.calibration_rows(
            folder, root, QUANT_CALIB_ROWS)
    calib_rows_s = time.perf_counter() - t
    bad = [str(w.message) for w in caught if "decode" in str(w.message)]
    if report_is_calib or report is None or bad:
        raise AssertionError(f"quantize: calibration rows {bad}")

    t = time.perf_counter()
    sess = InferenceSession.from_experiment_quantized(
        folder, calib, max_batch=SERVE_MAX_BATCH, calib_mode="max")
    quantize_s = time.perf_counter() - t
    qtree = sess.qtree
    fsess = InferenceSession.from_experiment(folder,
                                             max_batch=SERVE_MAX_BATCH)
    graph = trace.trace_graph(model_cfg, state_dict)
    t = time.perf_counter()
    fidelity = q.quantization_report(model_cfg, state_dict, qtree, report,
                                     device="cuda", graph=graph)
    report_s = time.perf_counter() - t
    got = sess.predict(report)
    with torch.inference_mode():
        ref = np.concatenate([trace.graph_forward(graph, q._eval_preprocess(
            CROP, False, None)(torch.from_numpy(report[i:i + 32]).to(
                "cuda"))).cpu().numpy() for i in range(0, len(report), 32)])
    margin = np.abs(ref[:, 1] - ref[:, 0])
    decided = margin >= QUANT_MARGIN
    flips = int((got["pred"][decided] != ref.argmax(1)[decided]).sum())
    max_dlogp = float(np.abs(got["log_probs"] - ref).max())
    if flips or not decided.any() \
            or not fidelity["mean_abs_dlogp"] <= QUANT_DLOGP:
        raise AssertionError(f"quantize: fidelity {fidelity} (mean |dlog p| "
                             f"limit {QUANT_DLOGP}), {flips} of "
                             f"{int(decided.sum())} decided rows change "
                             "class against the float32 graph")
    vs_float = q._fidelity(fsess.predict(report)["log_probs"],
                           got["log_probs"])
    percentile = _percentile_calibration(torch, q, model_cfg, state_dict,
                                         calib, report, graph)
    cpu_prog = q.build_infer_fn_quantized(qtree, device="cpu")
    with torch.inference_mode():
        cpu = np.concatenate([
            cpu_prog(torch.from_numpy(report[i:i + 64]))["log_probs"]
            .numpy() for i in range(0, len(report), 64)])
    held_cpu = _quant_held(np, "card vs cpu", got["log_probs"], cpu,
                           QUANT_ATOL)

    # the int8 session over HTTP
    n_req = SERVE_CLIENTS * SERVE_REQUESTS
    px = report[np.arange(n_req) % len(report)]
    sess.warm()
    direct = np.concatenate([sess.predict(px[i:i + SERVE_MAX_BATCH])
                             ["log_probs"]
                             for i in range(0, n_req, SERVE_MAX_BATCH)])
    batcher = DynamicBatcher(sess, window_ms=2.0).start()
    server = make_http_server(batcher, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        answers, lat, wall = _clients(base, px, SERVE_CLIENTS,
                                      SERVE_REQUESTS)
        stats = _http(base, "/stats")[1]
        code, health = _http(base, "/healthz")
        if code != 200:
            raise AssertionError(f"quantize /healthz {code}: {health}")
    finally:
        server.shutdown()
        server.server_close()
        batcher.stop()
    held_http = _quant_held(
        np, "http", [answers[i]["log_probs"] for i in range(n_req)],
        direct, QUANT_ATOL)

    # both int8 exports
    exports = {}
    for scheme in ("int8", "int8-weights"):
        out = os.path.join(work, f"flagship_{scheme}.pt2")
        t = time.perf_counter()
        manifest = export_model(
            folder, out, quantize=scheme,
            calib_pixels=calib if scheme == "int8" else None,
            report_pixels=report)
        export_s = time.perf_counter() - t
        quant = manifest["quantization"]
        keys = {"scheme", "agreement", "agreement_confident",
                "confident_fraction", "mean_abs_dlogp", "n"}
        if scheme == "int8":
            keys.add("calib_mode")
        if set(quant) != keys:
            raise AssertionError(f"export {scheme}: manifest keys "
                                 f"{sorted(quant)}")
        art = InferenceSession.from_artifact(out, max_batch=SERVE_MAX_BATCH)
        got_art = art.predict(px[:SERVE_MAX_BATCH])["log_probs"]
        if scheme == "int8":
            want_art = direct[:SERVE_MAX_BATCH]
        else:
            w8 = q.build_infer_fn_w8(
                model_cfg, q.quantize_weights_only(state_dict),
                device="cuda")
            with torch.inference_mode():
                want_art = w8(torch.from_numpy(px[:SERVE_MAX_BATCH]).to(
                    "cuda"))["log_probs"].float().cpu().numpy()
        exports[scheme] = {
            "export_s": export_s, "mb": manifest["bytes"] / 1e6,
            "batch": manifest["input"]["shape"][0],
            "quantization": quant,
            "held": _quant_held(np, f"export {scheme}", got_art, want_art,
                                1e-4),
        }

    # the trace files: the captured float graph and the int8 op list
    files = {}
    for name, ops in (("graph", graph.ops), ("int8", qtree["ops"])):
        path = os.path.join(work, f"trace_{name}.jsonl")
        n = trace.write_graph_jsonl(ops, path)
        with open(path) as f:
            records = [json.loads(line) for line in f]
        if n != len(ops) or [r["index"] for r in records] != list(
                range(1, len(ops) + 1)) or [r["op"] for r in records] != [
                    o["op"] for o in ops]:
            raise AssertionError(f"trace {name}: {n} records for "
                                 f"{len(ops)} ops, out of order")
        kinds = [r["op"] for r in records]
        files[name] = {"records": n, "conv": kinds.count("conv"),
                       "dense": kinds.count("dense"),
                       "act": kinds.count("act"),
                       "bytes": os.path.getsize(path)}
    n_q = sum(1 for r in qtree["ops"] if "kernel_q" in r)
    want_q = len(model_cfg.conv_features) + len(model_cfg.linear_features) + 1
    if n_q != want_q or files["int8"]["records"] != files["graph"]["records"]:
        raise AssertionError(f"quantize: {n_q} int8 contractions, want "
                             f"{want_q}")

    launches = [w.launches - n for w, n in zip(wrappers, launches_before)]
    if any(launches):
        raise AssertionError(f"the int8 path launched kernels: {launches}")
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    line = {
        "phase": "quantize", "model": model_cfg.name, "image": CROP,
        "calib_rows": len(calib), "report_rows": len(report),
        "calib_mode": qtree["calib_mode"], "calib_rows_s": calib_rows_s,
        "quantize_s": quantize_s, "report_s": report_s,
        "fidelity": fidelity, "dlogp_limit": QUANT_DLOGP,
        "max_abs_dlogp": max_dlogp, "vs_float_session": vs_float,
        "decided_rows": int(decided.sum()), "decided_margin": QUANT_MARGIN,
        "median_margin": float(np.median(margin)),
        "held_card_vs_cpu": held_cpu, "int8_contractions": n_q,
        "percentile": percentile,
        "clients": SERVE_CLIENTS, "requests": n_req,
        "req_per_s": n_req / wall,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p95_ms": float(np.percentile(lat_ms, 95)),
        "batches": stats["batches"], "max_coalesced": stats["max_coalesced"],
        "held_http": held_http, "exports": exports, "trace": files,
        "kernel_launches": launches,
        "seconds": time.perf_counter() - t0, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


# The hpo phase: one wave of HPO_K stacked trials of the flagship skeleton
# (3 extra conv blocks, 3 linear, adam; every layer padded to 256) at
# B=256 of 224² rows, bf16, microbatches of 32, for HPO_STEPS steps; each
# trial's losses against a lone (K=1) run of the same trial on the same
# rows and dropout draws. Then one wave of the reference's protocol, and
# the optuna CLI at a small size on the card, sequential and as waves.
HPO_K, HPO_BATCH, HPO_STEPS, HPO_ROWS = 4, 256, 3, 1024
# |stacked loss - lone loss| <= rtol * |lone loss|. At the first step
# (the same weights: the forwards differ by bf16 rounding only, the
# stacked convs running grouped under vmap and the lone ones plain)
# HPO_FIRST_RTOL; after it HPO_LOSS_RTOL, as each Adam step carries the
# rounding differences on (0.77% measured on an H100, where a lane left
# unchanged or given another lane's lr is 2-7% off by the third step).
# Trial 0 trains at the reference's winning lr 0.036, under which adam
# diverges on this arena (losses to 1.5e5) and the rounding grows with
# the loss: it alone is held at HPO_DIVERGED_RTOL after the first step.
HPO_FIRST_RTOL, HPO_LOSS_RTOL, HPO_DIVERGED_RTOL = 1e-3, 1e-2, 5e-2
# one wave of the reference's sweep protocol (HpoConfig: a 300-row sample
# a trial, 2/3 of it train, batches of 32, 10 epochs with median pruning)
# through run_wave_study as the optuna CLI runs it with --parallel 8 (TPE,
# seed 0), on the phase's pool: its trials over its wall time
HPO_SWEEP_TRIALS, HPO_SWEEP_WAVE = 8, 8


def phase_hpo(torch, work: str) -> dict:
    """HPO on the card (``hpo/``): the stacked wave's train step
    (``population.WavePrograms``) at full width, and the optuna CLI.

    - A seeded pool of HPO_ROWS 224² uint8 rows (two separable classes)
      on the card; HPO_K trials of the flagship skeleton: trial 0 the
      reference's winning widths, dropouts and lr
      (``space.best_hyperparameters``), the others sampled by
      ``wave._suggest_non_skeleton`` from a seeded RandomSampler study.
    - HPO_STEPS stacked steps on [HPO_K, HPO_BATCH] rows: the preprocess
      kernel's launches a step (must be 1: the wave converts the whole
      stack in one launch), the step's time and img/s summed over trials.
    - Each trial alone (K=1, its params, optimizer state, rows and dropout
      draws) for the same steps: its first loss within HPO_FIRST_RTOL of
      the stacked one and the later ones within HPO_LOSS_RTOL (trial 0,
      which diverges, HPO_DIVERGED_RTOL), relative, every loss finite;
      then the device time of one stacked step by kernel group
      (``_profile``).
    - One wave of the reference's protocol (``run_wave_study``,
      HPO_SWEEP_TRIALS trials in waves of HPO_SWEEP_WAVE at HpoConfig's
      sample, batch and epochs, 224², bf16, TPE) on the phase's pool:
      trials/hour as its trials over its wall time, every trial complete
      or pruned with a finite value.
    - ``tone_bias_optuna`` on the card in a scratch directory: 2 trials
      sequential (``hpo.objective``: one preprocess launch a train step)
      and 2 as a wave of 2, each writing its artifact."""
    import numpy as np

    from skin_image_analysis_tpu_torch.cli import tone_bias_optuna
    from skin_image_analysis_tpu_torch.config import HpoConfig
    from skin_image_analysis_tpu_torch.hpo.population import (
        WavePrograms,
        WaveSkeleton,
        _microbatching,
        wave_masks,
    )
    from skin_image_analysis_tpu_torch.hpo.space import best_hyperparameters
    from skin_image_analysis_tpu_torch.hpo.study import (
        RandomSampler,
        TrialReplay,
        TrialState,
        create_study,
    )
    from skin_image_analysis_tpu_torch.hpo.tpe import TPESampler
    from skin_image_analysis_tpu_torch.hpo.wave import (
        _lane_vectors,
        _suggest_non_skeleton,
        run_wave_study,
    )
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar as fpp,
    )

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    best = best_hyperparameters()
    skel = WaveSkeleton(n_conv=best["n_conv_layers"],
                        n_linear=best["n_linear_layers"],
                        optimizer=best["optimizer"], image_size=CROP,
                        compute_dtype="bfloat16")
    study = create_study("maximize", sampler=RandomSampler(15))
    vecs = [_lane_vectors(TrialReplay(best), skel.n_conv, skel.n_linear)]
    for _ in range(HPO_K - 1):
        t = study.ask()
        _suggest_non_skeleton(t, skel.n_conv, skel.n_linear)
        vecs.append(_lane_vectors(t, skel.n_conv, skel.n_linear))
    conv_w = torch.tensor([v[0] for v in vecs], device=dev)
    lin_w = torch.tensor([v[1] for v in vecs], device=dev)
    drops = torch.tensor([v[2] for v in vecs], device=dev)
    lrs = torch.tensor([v[3] for v in vecs], device=dev)

    gen = torch.Generator(device=dev).manual_seed(15)
    labels = torch.randint(0, 2, (HPO_ROWS,), generator=gen, device=dev)
    noise = torch.randn((HPO_ROWS, 3, CROP, CROP), generator=gen,
                        device=dev) * 12.0
    pool = (noise + 60.0 + 120.0 * labels[:, None, None, None]).clamp(
        0, 255).to(torch.uint8).contiguous()
    rows = torch.randint(0, HPO_ROWS, (HPO_STEPS, HPO_K, HPO_BATCH),
                         generator=gen, device=dev)

    microbatch, n_micro = _microbatching(skel, HPO_BATCH, None)
    progs = WavePrograms(skel, microbatch, n_micro, dev)
    masks = wave_masks(skel, conv_w, lin_w)
    params, opt = progs.init_wave([15 * 1009 + i for i in range(HPO_K)],
                                  conv_w, lin_w)
    start_state = ({n: v.clone() for n, v in params.items()},
                   {n: ({m: w.clone() for m, w in v.items()}
                        if isinstance(v, dict) else v.clone())
                    for n, v in opt.items()})
    draws = [progs.draw_noise(HPO_K, gen) for _ in range(HPO_STEPS)]

    losses, step_ms, per_step = [], [], []
    for i in range(HPO_STEPS):
        before = fpp.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, loss = progs.train_step(
            params, opt, pool, labels, rows[i], masks, drops, lrs, draws[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        per_step.append(fpp.launches - before)
        losses.append(loss.float().cpu().numpy())
    losses = np.stack(losses)                          # [steps, K]
    if per_step != [1] * HPO_STEPS:
        raise AssertionError(f"hpo: preprocess launches a stacked step "
                             f"{per_step}, want 1")
    stacked_launches = sum(per_step)

    # each trial alone: K=1 on its slice of the same state, rows and draws
    lone = np.zeros_like(losses)
    lone_launches = 0
    for k in range(HPO_K):
        sl = slice(k, k + 1)
        p = {n: v[sl].clone() for n, v in start_state[0].items()}
        o = {n: ({m: w[sl].clone() for m, w in v.items()}
                 if isinstance(v, dict) else v[sl].clone())
             for n, v in start_state[1].items()}
        mk = {n: v[sl] for n, v in masks.items()}
        for i in range(HPO_STEPS):
            before = fpp.launches
            p, o, loss = progs.train_step(
                p, o, pool, labels, rows[i, sl], mk, drops[sl], lrs[sl],
                [[u[sl] for u in mb] for mb in draws[i]])
            lone_launches += fpp.launches - before
            lone[i, k] = float(loss.float()[0])
    rel = np.abs(losses - lone) / np.abs(lone)
    rtol = np.full_like(rel, HPO_LOSS_RTOL)
    rtol[:, 0] = HPO_DIVERGED_RTOL
    rtol[0] = HPO_FIRST_RTOL
    first_err = float(rel[0].max())
    err = float(rel[1:, 1:].max()) if HPO_STEPS > 1 else first_err
    diverged_err = float(rel[1:, 0].max()) if HPO_STEPS > 1 else first_err
    if not (np.isfinite(losses).all() and np.isfinite(lone).all()) \
            or (rel > rtol).any():
        raise AssertionError(f"hpo: stacked losses {losses.tolist()} vs "
                             f"lone {lone.tolist()}: relative errors "
                             f"{rel.tolist()} against {rtol.tolist()}")
    warm_ms = float(np.median(step_ms[1:])) if HPO_STEPS > 1 \
        else step_ms[0]
    step_s = warm_ms / 1e3
    # device time of one stacked step by kernel group (its launches are
    # the profile's own, not the main path's: they stay out of the count;
    # the launches a step are the wrapper's count above)
    before = fpp.launches
    profile = _profile(torch, lambda: progs.train_step(
        params, opt, pool, labels, rows[0], masks, drops, lrs, draws[0]),
        1, HPO_K * HPO_BATCH)
    profile_launches = fpp.launches - before
    del params, opt, start_state, progs

    # one wave of the reference's protocol, as the optuna CLI runs it
    sweep_cfg = HpoConfig(trials=HPO_SWEEP_TRIALS)
    nhwc = pool.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    before = fpp.launches
    sweep_study, stats = run_wave_study(
        nhwc, labels.cpu().numpy(), sweep_cfg, image_size=CROP,
        study=create_study("maximize", sampler=TPESampler(sweep_cfg.seed)),
        wave_size=HPO_SWEEP_WAVE, verbose=False, device=dev)
    sweep_launches = fpp.launches - before
    states = [t.state for t in sweep_study.trials]
    values = [t.value for t in sweep_study.trials]
    if stats["trials"] != HPO_SWEEP_TRIALS or any(
            st not in (TrialState.COMPLETE, TrialState.PRUNED)
            for st in states) or not np.isfinite(
                np.asarray(values, float)).all() \
            or sweep_launches != stats["preprocess_launches"] \
            or sweep_launches < 1:
        raise AssertionError(f"hpo sweep: {stats}, states {states}, "
                             f"values {values}, {sweep_launches} launches")
    n_sample = min(sweep_cfg.sample_size, HPO_ROWS)
    sweep = {
        "trials": stats["trials"], "waves": stats["waves"],
        "refills": stats["refills"],
        "complete": states.count(TrialState.COMPLETE),
        "pruned": states.count(TrialState.PRUNED),
        "sample_size": sweep_cfg.sample_size,
        "train_rows_a_trial_epoch": min(
            int(2 / 3 * n_sample) // sweep_cfg.batch_size,
            sweep_cfg.n_train_examples // sweep_cfg.batch_size)
        * sweep_cfg.batch_size,
        "batch": sweep_cfg.batch_size, "epochs": sweep_cfg.epochs,
        "lane_epochs": stats["lane_epochs"],
        "live_lane_epochs": stats["live_lane_epochs"],
        "seconds": stats["elapsed_s"],
        "trials_per_hour": stats["trials"] * 3600.0 / stats["elapsed_s"],
        "best_value": max(values), "launches": sweep_launches,
    }

    # the CLI, sequential and as waves, small, on the card
    cli = {}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for name, extra in (("objective", []), ("wave", ["--parallel", "2"])):
            before = fpp.launches
            t = time.perf_counter()
            rc = tone_bias_optuna.main(
                ["--trials", "2", "--epochs", "1", "--image-size", "64",
                 "--batch-size", "32", "--sample-size", "144",
                 "--sampler", "random", *extra])
            if rc != 0:
                raise AssertionError(f"tone_bias_optuna {name}: rc {rc}")
            with open(f"optuna_2_1_{dev.type}_32_144.json") as f:
                art = json.load(f)
            if art["device"] != dev.type or art["n_complete"] + art[
                    "n_pruned"] != 2:
                raise AssertionError(f"tone_bias_optuna {name}: {art}")
            cli[name] = {"seconds": time.perf_counter() - t,
                         "launches": fpp.launches - before,
                         "best_value": art["best_value"]}
            if cli[name]["launches"] < 1:
                raise AssertionError(f"tone_bias_optuna {name}: no "
                                     "preprocess launch")
    finally:
        os.chdir(cwd)

    line = {
        "phase": "hpo", "image": CROP, "batch": HPO_BATCH, "trials": HPO_K,
        "skeleton": [skel.n_conv, skel.n_linear, skel.optimizer],
        "pad_width": skel.pad_width, "microbatch": microbatch,
        "conv_widths": conv_w.tolist(), "linear_widths": lin_w.tolist(),
        "lrs": lrs.tolist(), "steps": HPO_STEPS, "step_ms": step_ms,
        "img_per_s": HPO_K * HPO_BATCH / step_s,
        "preprocess_launches_per_step": per_step,
        "losses": losses.tolist(), "lone_losses": lone.tolist(),
        "max_rel_loss_err": err, "diverged_rel_loss_err": diverged_err,
        "first_step_rel_err": first_err, "loss_rtol": HPO_LOSS_RTOL,
        "diverged_rtol": HPO_DIVERGED_RTOL,
        "first_step_rtol": HPO_FIRST_RTOL,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "profile": profile, "profile_launches": profile_launches,
        "sweep": sweep, "cli": cli,
        "launches": stacked_launches + lone_launches + sweep_launches
        + sum(c["launches"] for c in cli.values()),
        "seconds": time.perf_counter() - t0, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


# phase parallel (b): 2 steps of the global batch of BATCH rows from a
# seeded PAR_ROWS-row arena, in float32 with TF32 off
PAR_ROWS, PAR_STEPS = 512, 2
PAR_LOSS_RTOL, PAR_PARAM_TOL = 1e-5, 1e-4
PAR_WEIGHTS = (0.3, 1.7)
# phase parallel (c): run_wave_study over [cuda:0, cuda:0] and on one
# device at B=HPO_BATCH: PAR_HPO_TRIALS trials of 2 epochs in lanes of 2
# (at B=256 a padded lane pair is the population's cap), so both first
# trials finish at epoch 2 and are refilled once. RandomSampler seed 168
# draws phase hpo's skeleton (3 convs, 3 linears, adam) first. The trial
# values are validation accuracies over PAR_HPO_VALID rows: held to one
# row (a near-tie decided the other way by a lane group's rounding)
PAR_HPO_ROWS, PAR_HPO_TRIALS, PAR_HPO_EPOCHS, PAR_HPO_VALID = 384, 4, 2, 64
PAR_HPO_SEED, PAR_HPO_SKELETON = 168, [3, 3, "adam"]
PAR_HPO_VALUE_ATOL = 1.0 / PAR_HPO_VALID + 1e-9
# phase parallel (d): resnet18 (BatchNorm), bf16, augmented, at 224² crops
# of a seeded BN_DP_ROWS-row 256² arena: BN_DP_STEPS sgd steps of a
# global batch of BN_DP_BATCH rows, over two gloo ranks and in one process
BN_DP_ROWS, BN_DP_BATCH, BN_DP_STEPS, BN_DP_LR = 64, 32, 2, 1e-2
BN_DP_INVALID = 3  # invalid rows at the head of step 1 (rank 0's half)
# the ranks against one process: each loss to BN_DP_LOSS_RTOL relative;
# the parameters' distance from one process's, over the length of one
# process's own move from the init (L2 over every tensor), below
# BN_DP_PARAM_RTOL, and the running statistics' likewise below
# BN_DP_STATS_RTOL. bf16 rounds the gradients of 16 rows and of 32
# differently, and two sgd steps carry that on: on an H100 the ranks
# measured 1.3e-4 on the second loss, 0.017 on the parameters and 5.9e-5
# on the statistics; with each rank's own statistics 6.5e-3, 0.16 and
# 0.012, each bound between the two
BN_DP_LOSS_RTOL, BN_DP_PARAM_RTOL, BN_DP_STATS_RTOL = 1e-3, 0.05, 1e-3


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _workers(specs: list[dict], env: list[dict], timeout: float) -> list:
    """Run ``chip_smoke.py --worker <spec>`` once per spec, all at once,
    with the variables of ``env`` added; wait for every one (killing them
    all on a failure or at ``timeout``) and return each one's JSON
    result."""
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--worker",
         json.dumps(spec)], env={**os.environ, **extra},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for spec, extra in zip(specs, env)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError(f"worker {p.args[-1]} failed "
                                     f"({p.returncode}):\n{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _rank_env(rank: int, world: int, port: int) -> dict:
    return {"SIA_COORDINATOR": f"127.0.0.1:{port}",
            "SIA_NUM_PROCESSES": str(world), "SIA_PROCESS_ID": str(rank)}


def _par_steps(torch, mesh) -> tuple[dict, dict]:
    """Phase parallel (b)'s run: the flagship at full width in float32,
    PAR_STEPS steps of the global batch (the first BATCH // 6 rows of step 1 invalid,
    all in the first half, with class weights) through
    ``multi_train_step`` on ``mesh`` (None: one process). Returns (its
    line: losses, step ms, preprocess launches; the whole state_dict on
    the CPU)."""
    import numpy as np

    from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar as fpp,
    )
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        AugmentConfig,
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.parallel.tensor import (
        full_state_dict,
        shard_train_state,
    )
    from skin_image_analysis_tpu_torch.train.state import create_train_state
    from skin_image_analysis_tpu_torch.train.step import multi_train_step

    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    state = create_train_state(ModelConfig(compute_dtype="float32",
                                           image_size=CROP),
                               OptimConfig(), 0, dev)
    if mesh is not None:
        import torch.distributed as dist

        with torch.no_grad():
            for t in state.model.parameters():
                dist.broadcast(t, src=0)
        shard_train_state(state, mesh)
    gen = torch.Generator(device=dev).manual_seed(17)
    arena = torch.randint(0, 256, (PAR_ROWS, 3, SIZE, SIZE), generator=gen,
                          device=dev, dtype=torch.uint8)
    rng = np.random.default_rng(17)
    idx = rng.permutation(PAR_ROWS)[:PAR_STEPS * BATCH].reshape(
        PAR_STEPS, BATCH).astype(np.int32)
    labels = rng.integers(0, 2, (PAR_STEPS, BATCH))
    valid = np.ones((PAR_STEPS, BATCH), bool)
    valid[0, :BATCH // 6] = False
    pre = make_preprocess_fn(
        CROP, train=True, layout="planar", out_dtype="float32",
        augment=AugmentConfig(brightness=0.1, contrast=0.1, saturation=0.1))
    launches0 = fpp.launches
    losses, step_ms = [], []
    for i in range(PAR_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = multi_train_step(state, arena, idx[i:i + 1], labels[i:i + 1],
                             valid[i:i + 1], PAR_WEIGHTS, pre, mesh=mesh)
        losses.append(float(m["loss"][0]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    sd = state.model.state_dict() if mesh is None else full_state_dict(
        state.model)
    return ({"losses": losses, "step_ms": step_ms,
             "launches": fpp.launches - launches0},
            {k: v.detach().cpu() for k, v in sd.items()})


def _bn_steps(torch, mesh, global_stats: bool = True
              ) -> tuple[dict, dict, dict]:
    """Phase parallel (d)'s run: resnet18 at 224², bf16, ImageNet-
    normalized augmented input through the preprocess kernel (random crop
    256 -> 224, flip, jitter), head dropout 0.5, sgd; BN_DP_STEPS steps of
    BN_DP_BATCH rows through ``multi_train_step`` on ``mesh`` (None: one
    process). ``global_stats=False`` keeps each rank's BatchNorm
    statistics to its own rows (the train step's global reduction left
    out), the run the check must tell apart. Returns (its line: losses,
    step ms, preprocess launches; the final and the initial state_dict on
    the CPU)."""
    import contextlib

    import numpy as np

    from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar as fpp,
    )
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        AugmentConfig,
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.train import step as step_lib
    from skin_image_analysis_tpu_torch.train.state import create_train_state

    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    state = create_train_state(
        ModelConfig(name="resnet18", image_size=CROP,
                    compute_dtype="bfloat16"),
        OptimConfig(optimizer="sgd", learning_rate=BN_DP_LR), 0, dev)
    if mesh is not None:
        import torch.distributed as dist

        with torch.no_grad():
            for t in (*state.model.parameters(), *state.model.buffers()):
                dist.broadcast(t, src=0)
    init = {k: v.detach().cpu().clone()
            for k, v in state.model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(19)
    arena = torch.randint(0, 256, (BN_DP_ROWS, 3, SIZE, SIZE), generator=gen,
                          device=dev, dtype=torch.uint8)
    rng = np.random.default_rng(19)
    idx = rng.permutation(BN_DP_ROWS)[:BN_DP_STEPS * BN_DP_BATCH].reshape(
        BN_DP_STEPS, BN_DP_BATCH).astype(np.int32)
    labels = rng.integers(0, 2, (BN_DP_STEPS, BN_DP_BATCH))
    valid = np.ones((BN_DP_STEPS, BN_DP_BATCH), bool)
    valid[0, :BN_DP_INVALID] = False
    pre = make_preprocess_fn(
        CROP, train=True, layout="planar", out_dtype="bfloat16",
        normalize_imagenet=True,
        augment=AugmentConfig(brightness=0.1, contrast=0.1, saturation=0.1))
    launches0 = fpp.launches
    losses, step_ms = [], []
    reduce = step_lib.global_batch_stats
    if not global_stats:
        step_lib.global_batch_stats = (
            lambda *a, **kw: contextlib.nullcontext())
    try:
        for i in range(BN_DP_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step_lib.multi_train_step(
                state, arena, idx[i:i + 1], labels[i:i + 1],
                valid[i:i + 1], None, pre, mesh=mesh)
            losses.append(float(m["loss"][0]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        step_lib.global_batch_stats = reduce
    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    return ({"losses": losses, "step_ms": step_ms,
             "launches": fpp.launches - launches0}, sd, init)


def _bn_held(got: dict, single: dict, init: dict) -> dict:
    """(parameter, running statistics) distances of ``got`` from
    ``single``, each over the length of ``single``'s move from ``init``
    (L2 over every such tensor)."""
    out = {}
    for name, keep in (("params", lambda k: "running" not in k),
                       ("running_stats", lambda k: "running" in k)):
        keys = [k for k in single if keep(k)]
        off = sum(float(((got[k].float() - single[k].float()) ** 2).sum())
                  for k in keys)
        moved = sum(float(((single[k].float() - init[k].float()) ** 2)
                          .sum()) for k in keys)
        out[name] = math.sqrt(off / moved)
    return out


def _worker(spec: dict) -> int:
    """One process that phase parallel starts: ``train_cli`` runs the
    train CLI in ``spec["cwd"]`` (under a process group when the launcher
    variables are set: ``init_runtime`` joins it), ``steps`` is one rank
    of the two-rank gloo group on card 0 running ``_par_steps`` data and
    then tensor parallel, then ``_bn_steps`` data parallel with the
    global batch's BatchNorm statistics and with each rank's own. Prints
    one JSON line with its preprocess launches."""
    sys.path.insert(0, str(ROOT))
    import torch

    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar as fpp,
    )

    torch.backends.cudnn.deterministic = True
    out = {}
    if spec["kind"] == "train_cli":
        import contextlib

        from skin_image_analysis_tpu_torch.cli import tone_bias_train

        os.chdir(spec["cwd"])
        t = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rc = tone_bias_train.main(spec["argv"])
        out = {"rc": rc, "seconds": time.perf_counter() - t,
               "group": torch.distributed.is_initialized()}
    else:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        from skin_image_analysis_tpu_torch.config import MeshConfig
        from skin_image_analysis_tpu_torch.parallel import create_mesh
        from skin_image_analysis_tpu_torch.parallel.distributed import (
            maybe_initialize,
        )

        if not maybe_initialize(device="cuda:0", backend="gloo"):
            raise AssertionError("no process group")
        rank = torch.distributed.get_rank()
        for name, (dp, mp) in (("dp", (2, 1)), ("tp", (1, 2))):
            mesh = create_mesh(MeshConfig(data_parallel=dp,
                                          model_parallel=mp))
            t = time.perf_counter()
            line, sd = _par_steps(torch, mesh)
            line["seconds"] = time.perf_counter() - t
            if rank == 0:
                torch.save(sd, os.path.join(spec["out"], f"{name}.pt"))
            out[name] = line
        mesh = create_mesh(MeshConfig(data_parallel=2))
        for name, global_stats in (("bn", True), ("bn_local", False)):
            t = time.perf_counter()
            line, sd, _ = _bn_steps(torch, mesh, global_stats)
            line["seconds"] = time.perf_counter() - t
            if rank == 0:
                torch.save(sd, os.path.join(spec["out"], f"{name}.pt"))
            out[name] = line
        torch.distributed.destroy_process_group()
    out["launches"] = fpp.launches
    print(json.dumps(out), flush=True)
    return 0


def phase_parallel(torch, work: str, root: str, ctx: dict) -> dict:
    """Scale-out on the one card (``parallel/``). It measures nothing about
    multi-card speed.

    (a) ``tone_bias_train <root> 1 balance --augment`` at full width in a
        subprocess that joins a world-size-1 NCCL group from the
        ``SIA_*`` variables (``init_runtime``), and the same run in a
        subprocess without them, at once: the group's
        ``session_model.msgpack`` must equal the other's bit for bit (a
        one-rank all-reduce changes nothing), and so must its records but
        for their time fields (cuDNN deterministic in both).
    (b) Two ranks on card 0 over gloo (NCCL refuses two ranks on one
        card), at full width in float32 with TF32 off: DP (2 x 128 rows)
        and TP (data 1, model 2: the flatten Dense split) each take
        PAR_STEPS steps, held against one process at B=256 from the same
        seed and batches: losses to PAR_LOSS_RTOL relative, params to
        PAR_PARAM_TOL (absolute plus relative). The DP step's ms beside
        the single-process step's.
    (c) A serving session over the mesh ``[cuda:0, cuda:0]`` (two
        replicas, every batch split) held to the one-device session's
        log-probs (``_held_answers``' bf16 rule); ``run_wave_study`` with
        its lanes split over the same two positions and on one device,
        from the same seeds, at phase hpo's skeleton and batch, with a
        refill mid-wave: the same trials (parameters and states), their
        values within PAR_HPO_VALUE_ATOL. The split-and-merge code on the
        card.
    (d) The BatchNorm families data parallel: resnet18 (``_bn_steps``,
        224², bf16, augmented through the preprocess kernel, head dropout)
        over the same two gloo ranks (2 x 16 rows), held against one
        process at B=32 from the same weights and batches: each loss to
        BN_DP_LOSS_RTOL relative, the parameters within BN_DP_PARAM_RTOL
        and the running statistics within BN_DP_STATS_RTOL of one
        process's move; a run whose ranks keep their own BatchNorm
        statistics must fail that check (its power). One preprocess
        launch a step on each rank."""
    import dataclasses

    import numpy as np

    from skin_image_analysis_tpu_torch.config import HpoConfig, MeshConfig
    from skin_image_analysis_tpu_torch.hpo.study import (
        RandomSampler,
        create_study,
    )
    from skin_image_analysis_tpu_torch.hpo.wave import run_wave_study
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar as fpp,
    )
    from skin_image_analysis_tpu_torch.parallel import create_mesh
    from skin_image_analysis_tpu_torch.serve.server import InferenceSession
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    here = os.path.join(work, "parallel")
    argv = [root, "1", "balance", "--augment", "--batch-size", str(BATCH),
            "--image-size", str(CROP), "--steps-per-dispatch", str(K),
            "--seed", "0"]
    specs, envs = [], []
    for name, env in (("group", _rank_env(0, 1, _free_port())),
                      ("plain", {})):
        os.makedirs(os.path.join(here, name))
        specs.append({"kind": "train_cli", "argv": argv,
                      "cwd": os.path.join(here, name)})
        envs.append(env)
    t = time.perf_counter()
    group, plain = _workers(specs, envs, timeout=300)
    world1_s = time.perf_counter() - t
    folders = []
    for name, out in (("group", group), ("plain", plain)):
        [folder] = os.listdir(os.path.join(here, name, "results"))
        folders.append(os.path.join(here, name, "results", folder))
        if out["rc"] != 0 or out["group"] != (name == "group"):
            raise AssertionError(f"parallel (a) {name}: {out}")
    blobs = [open(os.path.join(f, ckpt.MODEL_FILENAME), "rb").read()
             for f in folders]
    times = ("epoch_time_s", "eval_time_s")
    records = [[{k: v for k, v in r.items() if k not in times}
                for r in _folder_records(f)] for f in folders]
    if blobs[0] != blobs[1] or records[0] != records[1] \
            or len(records[0]) != 1:
        raise AssertionError("parallel (a): the world-size-1 NCCL run's "
                             "model or records differ from the run "
                             "without a group")
    world1_launches = group["launches"] + plain["launches"]

    # (b) two ranks over gloo on card 0, against one process
    single, single_sd = _par_steps(torch, None)
    out_dir = os.path.join(here, "steps")
    os.makedirs(out_dir)
    port = _free_port()
    t = time.perf_counter()
    ranks = _workers([{"kind": "steps", "out": out_dir}] * 2,
                     [_rank_env(r, 2, port) for r in range(2)], timeout=300)
    two_rank_s = time.perf_counter() - t
    held = {}
    for name in ("dp", "tp"):
        got = ranks[0][name]
        if got["losses"] != ranks[1][name]["losses"]:
            raise AssertionError(f"parallel (b) {name}: the ranks' losses "
                                 "differ")
        loss_err = float(np.max(np.abs(np.subtract(
            got["losses"], single["losses"])) / np.abs(single["losses"])))
        sd = torch.load(os.path.join(out_dir, f"{name}.pt"))
        param_err = max(float(((sd[k] - v).abs()
                               - PAR_PARAM_TOL * v.abs()).max())
                        for k, v in single_sd.items())
        if loss_err > PAR_LOSS_RTOL or param_err > PAR_PARAM_TOL \
                or sd.keys() != single_sd.keys():
            raise AssertionError(f"parallel (b) {name}: loss rel err "
                                 f"{loss_err}, param err {param_err}")
        held[name] = {"losses": got["losses"],
                      "max_rel_loss_err": loss_err,
                      "max_param_err_over_rel": param_err,
                      "rank_step_ms": [r[name]["step_ms"] for r in ranks],
                      "rank_launches": [r[name]["launches"] for r in ranks],
                      "seconds": got["seconds"]}
    del single_sd

    # (d) resnet18 data parallel over the same ranks, against one process
    bn_single, bn_single_sd, bn_init = _bn_steps(torch, None)
    bn = {"single_losses": bn_single["losses"],
          "single_step_ms": bn_single["step_ms"],
          "loss_rtol": BN_DP_LOSS_RTOL, "param_rtol": BN_DP_PARAM_RTOL,
          "stats_rtol": BN_DP_STATS_RTOL}
    for name in ("bn", "bn_local"):
        got = ranks[0][name]
        if got["losses"] != ranks[1][name]["losses"] \
                or [r[name]["launches"] for r in ranks] != [BN_DP_STEPS] * 2:
            raise AssertionError(f"parallel (d) {name}: the ranks' losses "
                                 f"or launches differ: {ranks}")
        loss_err = float(np.max(np.abs(np.subtract(
            got["losses"], bn_single["losses"]))
            / np.abs(bn_single["losses"])))
        sd = torch.load(os.path.join(out_dir, f"{name}.pt"))
        if sd.keys() != bn_single_sd.keys():
            raise AssertionError(f"parallel (d) {name}: other tensors")
        bn[name] = {"losses": got["losses"], "max_rel_loss_err": loss_err,
                    "move_rel_err": _bn_held(sd, bn_single_sd, bn_init),
                    "rank_step_ms": [r[name]["step_ms"] for r in ranks],
                    "rank_launches": [r[name]["launches"] for r in ranks],
                    "seconds": got["seconds"]}
    def within(entry):
        move = entry["move_rel_err"]
        return (entry["max_rel_loss_err"] <= BN_DP_LOSS_RTOL
                and move["params"] <= BN_DP_PARAM_RTOL
                and move["running_stats"] <= BN_DP_STATS_RTOL)

    if not within(bn["bn"]):
        raise AssertionError(f"parallel (d): resnet18 over two ranks is "
                             f"off one process: {bn['bn']}")
    if within(bn["bn_local"]):
        raise AssertionError(f"parallel (d): per-rank statistics pass the "
                             f"check too: {bn['bn_local']}")
    del bn_single_sd, bn_init
    steps_launches = (single["launches"] + bn_single["launches"]
                      + sum(r["launches"] for r in ranks))

    # (c) the split-and-merge code on the card
    two = create_mesh(MeshConfig(data_parallel=2), ["cuda:0", "cuda:0"])
    folder = ctx["folder"]
    px = _serve_pixels(folder, ctx["root224"], 64)
    sharded = InferenceSession.from_experiment(folder, max_batch=64,
                                               mesh=two)
    plain_sess = InferenceSession.from_experiment(folder, max_batch=64)
    got, want = sharded.predict(px), plain_sess.predict(px)
    serve = _held_answers(np, "mesh", got["log_probs"], got["pred"],
                          want["log_probs"])
    serve["buckets"] = sharded.buckets
    del sharded, plain_sess

    # the port's run_wave_study over the mesh and on one device, from the
    # same seeds, at phase hpo's skeleton and batch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)
    labels = torch.randint(0, 2, (PAR_HPO_ROWS,), generator=gen, device=dev)
    nhwc = (torch.randn((PAR_HPO_ROWS, CROP, CROP, 3), generator=gen,
                        device=dev) * 12.0 + 60.0
            + 120.0 * labels[:, None, None, None]).clamp(0, 255).to(
                torch.uint8).cpu().numpy()
    labels = labels.cpu().numpy()
    wave_cfg = HpoConfig(trials=PAR_HPO_TRIALS, sample_size=PAR_HPO_ROWS,
                         batch_size=HPO_BATCH, epochs=PAR_HPO_EPOCHS,
                         n_train_examples=HPO_BATCH,
                         n_valid_examples=PAR_HPO_VALID, population=2,
                         seed=21)
    waves = {}
    for name, mesh in (("one_device", None), ("mesh", two)):
        before = fpp.launches
        t = time.perf_counter()
        study, stats = run_wave_study(
            nhwc, labels, wave_cfg, image_size=CROP,
            study=create_study("maximize",
                               sampler=RandomSampler(PAR_HPO_SEED)),
            wave_size=wave_cfg.population, mesh=mesh, verbose=False,
            device=dev)
        waves[name] = {
            "seconds": time.perf_counter() - t,
            "launches": fpp.launches - before, "stats": stats,
            "params": [tr.params for tr in study.trials],
            "states": [tr.state for tr in study.trials],
            "values": [tr.value for tr in study.trials]}
    one, split = waves["one_device"], waves["mesh"]
    skel = [one["params"][0][k] for k in ("n_conv_layers",
                                          "n_linear_layers", "optimizer")]
    value_err = max(abs(a - b) for a, b in zip(split["values"],
                                               one["values"]))
    for w in (one, split):
        if w["launches"] != w["stats"]["preprocess_launches"] \
                or w["launches"] < 1:
            raise AssertionError(f"parallel (c) wave: {w['launches']} "
                                 f"launches, stats {w['stats']}")
    if skel != PAR_HPO_SKELETON or len(one["values"]) != PAR_HPO_TRIALS \
            or split["params"] != one["params"] \
            or split["states"] != one["states"] \
            or not np.isfinite(np.asarray(split["values"], float)).all() \
            or value_err > PAR_HPO_VALUE_ATOL \
            or one["stats"]["refills"] < 1 \
            or split["stats"]["refills"] != one["stats"]["refills"] \
            or split["stats"]["lane_epochs"] != one["stats"][
                "lane_epochs"]:
        raise AssertionError(f"parallel (c) wave: over the mesh {split} "
                             f"against one device {one}")
    hpo_launches = one["launches"] + split["launches"]
    line = {
        "phase": "parallel",
        "world1_nccl": {"session_model_bitwise": True,
                        "records_equal": True, "seconds": world1_s,
                        "group_s": group["seconds"],
                        "plain_s": plain["seconds"]},
        "two_ranks_gloo": {**held, "seconds": two_rank_s,
                           "single_losses": single["losses"],
                           "single_step_ms": single["step_ms"],
                           "loss_rtol": PAR_LOSS_RTOL,
                           "param_tol": PAR_PARAM_TOL},
        "transfer_dp": {"model": "resnet18", "dtype": "bfloat16",
                        "image": CROP, "batch": BN_DP_BATCH,
                        "steps": BN_DP_STEPS, **bn},
        "serve_mesh": serve,
        "wave_mesh": {"skeleton": skel, "batch": HPO_BATCH,
                      "trials": len(split["values"]),
                      "refills": split["stats"]["refills"],
                      "lane_epochs": split["stats"]["lane_epochs"],
                      "values": split["values"],
                      "one_device_values": one["values"],
                      "max_value_err": value_err,
                      "value_atol": PAR_HPO_VALUE_ATOL,
                      "launches": [one["launches"], split["launches"]],
                      "seconds": [one["seconds"], split["seconds"]]},
        "launches": world1_launches + steps_launches + hpo_launches,
        "seconds": time.perf_counter() - t0, "card": nvidia_smi_line(),
    }
    emit(line)
    return line


def _skin_frames(torch, n: int, side: int, seed: int):
    """uint8 ``[n, side, side, 3]`` on the card: light and dark skin
    colours (``SKIN_RGB``, alternately) with noise of 40 a channel, so
    that some pixels fall outside the skin gamut."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.tensor(SKIN_RGB, device=dev)[torch.arange(n, device=dev)
                                              % 2]
    noise = torch.randint(-40, 41, (n, side, side, 3), device=dev,
                          generator=g)
    return (base[:, None, None, :] + noise).clamp(0, 255).to(torch.uint8)


def _lab64(np, rgb_u8):
    """``data.ita``'s Lab in float64, to measure how far a pixel lies from
    the skin gamut's bounds."""
    x = rgb_u8.astype(np.float64) / 255.0
    lin = np.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)
    m = np.array([[0.4124564, 0.3575761, 0.1804375],
                  [0.2126729, 0.7151522, 0.0721750],
                  [0.0193339, 0.1191920, 0.9503041]])
    t = lin @ m.T / np.array([0.95047, 1.0, 1.08883])
    f = np.where(t > 0.008856, np.cbrt(t), (903.3 * t + 16.0) / 116.0)
    return np.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]),
                     200 * (f[..., 1] - f[..., 2])], -1)


def _check_ita_pipeline(torch, name: str, px) -> dict:
    """``ita_pipeline`` on the card against the same call on the CPU, by
    the CPU tests' rules: the angles within 1e-3 degrees where both call a
    pixel skin, the masks apart only at pixels whose float64 Lab lies
    within 1e-4 of a gamut bound, the bands equal where both angles lie
    farther than 1e-3 from a threshold, the modal ITAs and tones equal;
    timed on the card."""
    import numpy as np

    from skin_image_analysis_tpu_torch.data.ita import (
        FITZ_THRESHOLDS,
        ita_pipeline,
    )
    from skin_image_analysis_tpu_torch.tools.perf_attrib import (
        cuda_ms,
        l2_flusher,
    )

    got = {k: v.cpu().numpy() for k, v in ita_pipeline(px).items()}
    torch.cuda.synchronize()
    want = {k: v.numpy() for k, v in ita_pipeline(px.cpu()).items()}
    a, b = got["ita"], want["ita"]
    both = ~np.isnan(a) & ~np.isnan(b)
    err = float(np.abs(a[both] - b[both]).max()) if both.any() else 0.0
    differ = np.isnan(a) != np.isnan(b)
    lab = _lab64(np, px.cpu().numpy()[differ])
    margin = np.abs(lab[..., :, None] - np.array(
        [[30, 80], [0, 20], [5, 25]])).min(-1).min(-1)
    far = both & (np.abs(b[..., None] - np.array(FITZ_THRESHOLDS))
                  .min(-1) > 1e-3)
    bands = int((got["fitzpatrick"] != want["fitzpatrick"])[far].sum())
    modal_equal = np.array_equal(got["modal_ita"], want["modal_ita"],
                                 equal_nan=True)
    if err > 1e-3 or (margin >= 1e-4).any() or bands or not modal_equal \
            or not np.array_equal(got["tone"], want["tone"]):
        raise AssertionError(
            f"ita_pipeline on the card ({name}): angle err {err} (atol "
            f"1e-3), {int(differ.sum())} mask differences, "
            f"{int((margin >= 1e-4).sum())} of them farther than 1e-4 from "
            f"a bound, {bands} band differences, modal ITAs equal "
            f"{modal_equal}")
    ms = cuda_ms(lambda: ita_pipeline(px), 10, l2_flusher(px.device))
    return {"frames": list(px.shape), "skin_share": float(both.mean()),
            "max_abs_err_deg": err, "mask_differences": int(differ.sum()),
            "ms": ms, "img_per_s": px.shape[0] / (ms / 1e3)}


def phase_ita(torch, work: str, root: str) -> dict:
    """The ITA path on the card.

    ``ita_pipeline`` over 64 seeded 256² skin-coloured frames and over 64
    of the ``cli`` cohort's frames, against the same call on the CPU
    (``_check_ita_pipeline``), timed. Then ``train_classifier`` with
    ``input_mode="ita"``: resnet50 at 224² with a 2-channel stem, phase
    ``transfer``'s tone labels and operating point, 1 epoch; checks one
    preprocess launch per live step, the step's identity-affine B=32
    preprocess call against its plain version, and the eval on the card
    against the same weights in float32 on the CPU by phase ``transfer``'s
    rules. Last, ``ModalItaClassifier`` in its three modes fit on the
    modal ITAs of the train frames, computed on the card, and scored on
    the test frames' (the cohort's frames are random colours, so the
    scores are of chance)."""
    import numpy as np

    from skin_image_analysis_tpu_torch.data.ita import ita_pipeline
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.toneclassifier import (
        ModalItaClassifier,
    )
    from skin_image_analysis_tpu_torch.train import classify

    skin = _check_ita_pipeline(torch, "skin frames",
                               _skin_frames(torch, ITA_ROWS, SIZE, 14))

    train_table, test_table = _tone_tables(root)
    cfg = _classify_config(os.path.join(work, "ita"), "resnet50", 1,
                           input_mode="ita")
    run = _classify_run(torch, train_table, test_table, cfg)
    trained, (train_arena, test_arena) = run["out"], run["arenas"]
    if trained["state"].model.stem_conv.weight.shape[1] != 2:
        raise AssertionError("the ITA model's stem does not take 2 channels")
    cohort = _check_ita_pipeline(
        torch, "cohort frames",
        train_arena[:ITA_ROWS].permute(0, 2, 3, 1).contiguous())
    kernel = _transfer_check_kernel(torch, train_arena, imagenet=False)
    pre = classify._ita_wrap(make_preprocess_fn(CROP, train=False,
                                                layout="planar"))
    evals = _eval_against_cpu(torch, "ita", trained, test_arena, pre)

    def modal(arena):
        return np.concatenate([
            ita_pipeline(arena[i:i + 256].permute(0, 2, 3, 1))["modal_ita"]
            .cpu().numpy() for i in range(0, arena.shape[0], 256)])

    x_train, x_test = modal(train_arena), modal(test_arena)
    scores = {}
    for mode in ("threshold", "logistic", "svm"):
        clf = ModalItaClassifier(mode).fit(x_train, train_table.labels)
        scores[mode] = clf.score(x_test, test_table.labels)
    line = {
        "phase": "ita", "ita_pipeline": {"skin": skin, "cohort": cohort},
        "model": "resnet50", "input_mode": "ita", "image": CROP,
        "batch": TRANSFER_BATCH, "k": TRANSFER_K,
        "train_rows": len(train_table), "test_rows": len(test_table),
        "epochs": cfg.epochs, "steps": sum(e["steps"] for e in run["epochs"]),
        "launches": run["launches"],
        "loss_first": float(run["losses"][0]),
        "loss_last": float(run["losses"][-1]),
        "epoch_train_s": run["epochs"][0]["train_s"],
        "epoch_img_per_s": _img_s(run["epochs"][0]),
        "decode_s": run["decode_s"], "wall_s": run["wall"],
        **evals, "preprocess": kernel,
        "modal_ita_scores": scores,
        "modal_ita_nan_share": float(np.isnan(x_train).mean()),
        "card": nvidia_smi_line(),
    }
    emit(line)
    return line


# Phase jpeg's cohort: (rows, height, width) of each JPEG source size (the
# HAM10000 frame, a common ISIC 2019 frame, and a frame that libjpeg
# decodes at its 1/8 DCT scale), then grayscale frames at the first size
# and files whose bytes are no JPEG: 2,048 rows in all.
JPEG_SOURCES = ((1024, 450, 600), (1000, 768, 1024), (16, 4000, 6000))
JPEG_GRAY, JPEG_GARBAGE = 4, 4
# rows of each source size (and the grayscale ones) decoded by the python
# path too: 256 in all
JPEG_PYTHON_ROWS = (120, 116, 16)
# the native arena's mean |difference| from the python path, by source
# size: the JAX package's own bound (tests/test_loader.py)
JPEG_MEAN_BOUND = 2.0
JPEG_ITA_ROWS, JPEG_ITA_HELD = 256, 32
# rows of each of the first two source sizes in the shortest-side arena
JPEG_SHORTEST_ROWS = 128


def _shortest_arena(root: str, groups: dict) -> dict:
    """``HostImageStore(resize_mode="shortest")`` (the reference's
    ``Rescale(int)``, then the centre square; the libjpeg decoder skipped)
    of JPEG_SHORTEST_ROWS rows of each of the cohort's 600x450 and
    1024x768 sources, timed; every row held byte for byte against the
    geometry restated with cv2 here (the shortest side to SIZE, the other
    rounded to keep the aspect, INTER_AREA down, the centre SIZE²), and
    the square arena of the same rows, which squeezes instead of
    cutting, must differ from it."""
    import cv2
    import numpy as np

    from skin_image_analysis_tpu_torch.data.dataset import LesionTable
    from skin_image_analysis_tpu_torch.data.ingest import read_csv
    from skin_image_analysis_tpu_torch.data.loader import HostImageStore

    names = [f"{w}x{h}" for _, h, w in JPEG_SOURCES[:2]]
    pick = [i for name in names for i in range(
        groups[name][0], groups[name][0] + JPEG_SHORTEST_ROWS)]
    table = LesionTable(read_csv(os.path.join(root, "metadata.csv"))
                        .take(pick), root)
    t = time.perf_counter()
    store = HostImageStore(table, SIZE, workers=8, resize_mode="shortest")
    shortest_s = time.perf_counter() - t
    square = HostImageStore(table, SIZE, workers=8).images

    def restated(path):
        img = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
        h, w = img.shape[:2]
        nh, nw = ((SIZE, round(SIZE * w / h)) if h < w
                  else (round(SIZE * h / w), SIZE))
        img = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
        y0, x0 = (nh - SIZE) // 2, (nw - SIZE) // 2
        return img[y0:y0 + SIZE, x0:x0 + SIZE].transpose(2, 0, 1)

    want = np.stack([restated(p) for p in table.file_paths()])
    if store.bad_rows or not np.array_equal(store.images, want) \
            or np.array_equal(store.images, square):
        raise AssertionError(
            f"shortest arena: {len(store.bad_rows)} bad rows, "
            f"{int((store.images != want).sum())} bytes off the restated "
            "geometry, or equal to the square arena")
    return {"rows": len(pick), "sources": names, "s": shortest_s,
            "img_per_s": len(pick) / shortest_s,
            "bytes_off_square": int((store.images != square).sum()),
            "held": "byte-equal to the restated geometry"}


def _jpeg_frame(np, seed: int, noise, light: bool, gray: bool):
    """A seeded skin-coloured frame of ``noise``'s size: 32-pixel cells of
    colour around the light or the dark ``SKIN_RGB``, plus ``noise`` (int16
    ``[h, w, 1]``, shared by the frames of a size); one channel if
    ``gray``."""
    h, w = noise.shape[:2]
    c = 1 if gray else 3
    ch, cw = -(-h // 32), -(-w // 32)
    cells = np.random.default_rng(seed).integers(-28, 29, (ch, cw, c),
                                                 dtype=np.int16)
    cells += np.array(SKIN_RGB[0 if light else 1], np.int16)[:c]
    img = np.broadcast_to(cells[:, None, :, None], (ch, 32, cw, 32, c))
    img = img.reshape(ch * 32, cw * 32, c)[:h, :w] + noise
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_jpeg(path: str, img) -> None:
    """cv2, else PIL; quality 90."""
    try:
        import cv2
    except ImportError:
        from PIL import Image

        Image.fromarray(img if img.shape[2] == 3 else img[..., 0]).save(
            path, quality=90)
        return
    ok = cv2.imwrite(path, img[..., ::-1] if img.shape[2] == 3 else img,
                     [cv2.IMWRITE_JPEG_QUALITY, 90])
    if not ok:
        raise IOError(f"cv2 could not write {path}")


def _write_jpeg_cohort(root: str, seed: int) -> dict:
    """metadata.csv (``_cohort_rows``) and one ``.jpg`` per row, encoded on
    a thread pool: the JPEG_SOURCES in order, then the grayscale frames
    and the garbage files. Returns the row groups by name."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    rng = np.random.default_rng(seed)
    groups, start = {}, 0
    for n, h, w in JPEG_SOURCES:
        groups[f"{w}x{h}"] = (start, n, h, w)
        start += n
    _, _, h0, w0 = groups[f"{JPEG_SOURCES[0][2]}x{JPEG_SOURCES[0][1]}"]
    groups["gray"] = (start, JPEG_GRAY, h0, w0)
    groups["garbage"] = (start + JPEG_GRAY, JPEG_GARBAGE, 0, 0)
    n_rows = start + JPEG_GRAY + JPEG_GARBAGE
    rows = _cohort_rows(rng, n_rows)
    _write_metadata(root, rows)
    noise = {(h, w): rng.integers(-8, 9, (h, w, 1), dtype=np.int16)
             for _, n, h, w in groups.values() if h}

    def one(i: int) -> None:
        path = os.path.join(root, rows[i]["isic_id"] + ".jpg")
        for name, (first, n, h, w) in groups.items():
            if first <= i < first + n:
                break
        if name == "garbage":
            with open(path, "wb") as f:
                f.write(b"not a JPEG " + np.random.default_rng(
                    [seed, i]).bytes(4096))
            return
        light = rows[i]["fitzpatrick_skin_type"] not in (
            "III", "IV", "V", "VI")
        _write_jpeg(path, _jpeg_frame(np, [seed, i], noise[h, w], light,
                                      name == "gray"))

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(one, range(n_rows)))
    return groups


def phase_jpeg(torch, work: str) -> dict:
    """The JPEG path on the card's machine, through the port's libjpeg
    decoder (``data.native_loader``, built from ``csrc/decoder.cc``).

    (a) Prints the decoder's libjpeg route and library on a line of its
    own; a decoder that does not build fails the run (no cv2 stands in).
    (b) Writes a seeded 2,048-row JPEG cohort (``_write_jpeg_cohort``).
    (c) Decodes it straight into a planar 256² arena with
    ``decode_batch_into`` and times it beside the python path (cv2 or PIL
    on 8 threads, as ``HostImageStore`` runs it) on 256 of the rows: the
    garbage files reported, the grayscale rows grey, the decoder timed on
    those rows too (the same bytes again), and the arena's mean
    |difference| from the python path below JPEG_MEAN_BOUND on each
    source size; a shortest-side arena of 256 of the 600x450 and
    1024x768 rows (``_shortest_arena``). (d) Runs ``tone_bias_train
    <root> 2 balance --augment`` at full width on the cohort, then
    ``tone_bias_test``: the train
    store's arenas byte-equal to (c)'s rows, the garbage rows invalid, one
    preprocess launch per train step. (e) Runs ``tone_classifier_train
    <root> 1 --model resnet18`` on the Fitzpatrick-typed rows and
    ``images_to_ita`` on 256 of the frames, with the folders and printed
    lines checked, and the ITA matrices of the first 32 frames held
    against ``ita_pipeline`` on the card and on the CPU. The host's
    decode rates are the card machine's CPU's, not the card's."""
    import contextlib
    import csv
    import io
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from skin_image_analysis_tpu_torch.cli import (
        images_to_ita,
        tone_bias_test,
        tone_bias_train,
        tone_classifier_train,
    )
    from skin_image_analysis_tpu_torch.data import native_loader
    from skin_image_analysis_tpu_torch.data.ita import ita_pipeline
    from skin_image_analysis_tpu_torch.data.loader import decode_image
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.train import loop

    # (a) the decoder, built from the checkout's source
    t = time.perf_counter()
    route, library = native_loader.library()  # raises if it cannot build
    build_s = time.perf_counter() - t
    n_threads = min(16, (os.cpu_count() or 1) * 2)
    emit({"phase": "jpeg_setup", "libjpeg_route": route,
          "library": os.path.relpath(library, ROOT), "build_s": build_s,
          "n_threads": n_threads, "cpu_count": os.cpu_count()})

    # (b) the cohort
    jwork = os.path.join(work, "jpeg")
    root = os.path.join(jwork, "cohort")
    os.makedirs(root)
    t = time.perf_counter()
    groups = _write_jpeg_cohort(root, seed=18)
    write_s = time.perf_counter() - t
    with open(os.path.join(root, "metadata.csv"), newline="") as f:
        ids = [row["isic_id"] for row in csv.DictReader(f)]
    paths = [os.path.join(root, f"{i}.jpg") for i in ids]
    row_of = {isic_id: i for i, isic_id in enumerate(ids)}

    # (c) the cohort decoded into one planar arena, beside the python path
    arena = np.empty((len(paths), 3, SIZE, SIZE), np.uint8)
    t = time.perf_counter()
    failed = native_loader.decode_batch_into(paths, arena,
                                             on_error="report")
    native_s = time.perf_counter() - t
    g0, gn = groups["garbage"][:2]
    if sorted(failed) != list(range(g0, g0 + gn)) or arena[g0:].any():
        raise AssertionError(f"decoder reported {sorted(failed)}, not the "
                             f"garbage rows {g0}..{g0 + gn - 1}")
    gray0 = groups["gray"][0]
    gray = arena[gray0:gray0 + JPEG_GRAY]
    if not ((gray[:, 0] == gray[:, 1]).all()
            and (gray[:, 1] == gray[:, 2]).all()):
        raise AssertionError("a grayscale JPEG decoded to unequal channels")
    sample = {}
    for (name, (first, n, _, _)), k in zip(
            groups.items(), (*JPEG_PYTHON_ROWS, JPEG_GRAY)):
        sample[name] = list(range(first, first + min(k, n)))
    rows = [i for name in sample for i in sample[name]]
    again = np.empty((len(rows), 3, SIZE, SIZE), np.uint8)
    t = time.perf_counter()
    native_loader.decode_batch_into([paths[i] for i in rows], again)
    native_rows_s = time.perf_counter() - t
    if not np.array_equal(again, arena[rows]):
        raise AssertionError("the decoder gave other bytes the second time")
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        python = list(pool.map(lambda i: decode_image(paths[i], SIZE),
                               rows))
    python_s = time.perf_counter() - t
    python = dict(zip(rows, python))
    diffs = {}
    for name, idx in sample.items():
        d = np.abs(arena[idx].transpose(0, 2, 3, 1).astype(np.int16)
                   - np.stack([python[i] for i in idx]))
        diffs[name] = {"rows": len(idx), "mean_abs": float(d.mean()),
                       "max_abs": int(d.max())}
        if d.mean() >= JPEG_MEAN_BOUND:
            raise AssertionError(f"{name}: the decoder's arena is "
                                 f"{d.mean()} from the python path "
                                 f"(bound {JPEG_MEAN_BOUND})")

    shortest = _shortest_arena(root, groups)

    # (d) the train CLI, then the test CLI, on the cohort
    cwd = os.getcwd()
    log = io.StringIO()
    try:
        os.chdir(jwork)
        stores, losses = [], []

        def keep_stores(decode):
            def call(*a, **kw):
                out = decode(*a, **kw)
                stores.extend(out[0])
                return out
            return call

        def record_losses(step):
            def call(*a, **kw):
                m = step(*a, **kw)
                losses.append((m["loss"], m["count"]))
                return m
            return call

        fused_preprocess_planar.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        with _Patch(loop, "_decode_arenas", keep_stores), \
                _Patch(loop, "multi_train_step", record_losses), \
                contextlib.redirect_stdout(log):
            argv = [root, "2", "balance", "--augment", "--batch-size",
                    str(BATCH), "--image-size", str(CROP),
                    "--steps-per-dispatch", str(K), "--seed", "0",
                    "--device", "cuda"]
            if tone_bias_train.main(argv) != 0:
                raise AssertionError(f"tone_bias_train {argv} failed")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = fused_preprocess_planar.launches
        step_losses = torch.cat([lo for lo, _ in losses]).cpu().numpy()
        live = torch.cat([c for _, c in losses]).cpu().numpy() > 0
        if not np.isfinite(step_losses).all():
            raise AssertionError(f"non-finite losses {step_losses}")
        [folder] = os.listdir(os.path.join(jwork, "results"))
        folder = os.path.join(jwork, "results", folder)
        n_train = len(_read_split(folder, loop.TRAIN_SET_FILENAME))
        test_ids = _read_split(folder, loop.TEST_SET_FILENAME)
        steps = int(live.sum())
        if launches != steps or steps != 2 * (n_train // BATCH):
            raise AssertionError(f"preprocess kernel launched {launches} "
                                 f"times for {steps} train steps")
        garbage_ids = set(ids[g0:g0 + gn])
        invalid = 0
        for store in stores:
            split = store.table.metadata.column("isic_id")
            if not np.array_equal(store.images,
                                  arena[[row_of[i] for i in split]]):
                raise AssertionError("the train CLI's arena differs from "
                                     "the decoder's")
            want = [k for k, i in enumerate(split) if i in garbage_ids]
            if store.bad_rows != want or store.row_ok[want].any():
                raise AssertionError(f"bad rows {store.bad_rows}, garbage "
                                     f"rows {want}")
            invalid += len(want)
        if len(stores) != 2 or not invalid:
            raise AssertionError(f"{len(stores)} stores, {invalid} garbage "
                                 f"rows among them")
        # the eval records count the test split's valid rows
        n_valid = len(test_ids) - len(garbage_ids.intersection(test_ids))
        _check_records(_folder_records(folder), n_valid, 2)

        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if tone_bias_test.main([root, folder, "--device", "cuda"]) != 0:
                raise AssertionError("tone_bias_test failed")
        test_s = time.perf_counter() - t
        text = out.getvalue()
        log.write(text)
        record = json.loads(text[text.index("{"):text.rindex("}") + 1])
        if record["total"] != n_valid:
            raise AssertionError(f"test CLI covered {record['total']} of "
                                 f"{n_valid} valid rows")

        # (e) the tone classifier and the ITA CLIs on the JPEGs
        tone_out = os.path.join(jwork, "tone_runs")
        out = io.StringIO()
        fused_preprocess_planar.launches = 0
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if tone_classifier_train.main(
                    [root, "1", "--model", "resnet18", "--out", tone_out,
                     "--device", "cuda"]) != 0:
                raise AssertionError("tone_classifier_train failed")
        torch.cuda.synchronize()
        tone_s = time.perf_counter() - t
        tone_launches = fused_preprocess_planar.launches
        text = out.getvalue()
        log.write(text)
        labels = [ln.partition(": ")[0] for ln in text.strip().splitlines()]
        files = set(os.listdir(tone_out))
        if labels != ["epoch 0", "final test metrics", "metrics log",
                      "model artifact"] or not {
                "session_model.msgpack", "metrics.jsonl",
                "train_config.json"} <= files or tone_launches < 1:
            raise AssertionError(f"tone_classifier_train printed {labels}, "
                                 f"kept {sorted(files)}, launched the "
                                 f"preprocess kernel {tone_launches} times")
        final = re.search(r"'accuracy': ([-+.\w]+)",
                          text.strip().splitlines()[1])

        ita_in = os.path.join(jwork, "ita_in")
        ita_out = os.path.join(jwork, "ita_out")
        os.makedirs(ita_in)
        names = [f"{i}.jpg" for i in ids[:JPEG_ITA_ROWS]]
        for name in names:
            os.symlink(os.path.join(root, name), os.path.join(ita_in, name))
        summary = os.path.join(jwork, "ita.csv")
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            if images_to_ita.main([ita_in, ita_out, "--summary-csv",
                                   summary, "--device", "cuda"]) != 0:
                raise AssertionError("images_to_ita failed")
        ita_s = time.perf_counter() - t
        text = out.getvalue()
        log.write(text)
        with open(summary, newline="") as f:
            ita_rows = list(csv.DictReader(f))
        npys = sorted(os.listdir(ita_out))
        if not text.startswith(f"{len(names)} images, {len(names)} to "
                               f"process") or len(ita_rows) != len(names) \
                or npys != sorted(n[:-4] + ".npy" for n in names):
            raise AssertionError(f"images_to_ita: {text[:80]!r}, "
                                 f"{len(ita_rows)} summary rows, "
                                 f"{len(npys)} matrices")
        px = torch.from_numpy(np.stack([
            decode_image(os.path.join(ita_in, n), CROP)
            for n in names[:JPEG_ITA_HELD]])).to("cuda")
        card = ita_pipeline(px)["ita"].cpu().numpy()
        saved = np.stack([np.load(os.path.join(ita_out, n[:-4] + ".npy"))
                          for n in names[:JPEG_ITA_HELD]])
        np.testing.assert_array_equal(saved, card)
        held = _check_ita_pipeline(torch, "jpeg frames", px)
    except BaseException:
        print(log.getvalue()[-4000:], file=sys.stderr)
        raise
    finally:
        os.chdir(cwd)
    decoded = len(paths) - len(failed)
    line = {
        "phase": "jpeg", "libjpeg_route": route, "rows": len(paths),
        "sources": {name: n for name, (_, n, _, _) in groups.items()},
        "write_cohort_s": write_s,
        "decode": {"native_s": native_s, "decoded": decoded,
                   "native_img_per_s": decoded / native_s,
                   "n_threads": n_threads, "python_rows": len(rows),
                   "native_rows_s": native_rows_s,
                   "native_rows_img_per_s": len(rows) / native_rows_s,
                   "python_s": python_s, "python_threads": 8,
                   "python_img_per_s": len(rows) / python_s,
                   "reported": sorted(failed), "vs_python": diffs,
                   "rate": "the host's CPU, not the card"},
        "train_rows": n_train, "test_rows": len(test_ids),
        "test_rows_valid": n_valid,
        "garbage_rows_invalid": invalid, "epochs": 2, "batch": BATCH,
        "k": K, "steps": steps, "launches": launches,
        "loss_first": float(step_losses[live][0]),
        "loss_last": float(step_losses[live][-1]),
        "train_cli_s": train_s, "test_cli_s": test_s,
        "test_accuracy": record["accuracy"],
        "tone_classifier": {"model": "resnet18", "s": tone_s,
                            "launches": tone_launches,
                            "accuracy": final and float(final[1])},
        "ita": {"images": len(names), "s": ita_s, "held": held},
        "shortest_arena": shortest,
        "card": nvidia_smi_line(),
    }
    emit(line)
    return line


# name: (OptimConfig fields beyond the learning rate)
OPTIMIZERS = {
    "adamw": dict(optimizer="adamw", weight_decay=1e-2,
                  moment_dtype="bfloat16"),
    "rmsprop": dict(optimizer="rmsprop"),
    "sgd": dict(optimizer="sgd"),
    "sgd_momentum": dict(optimizer="sgd", momentum=0.9),
}


def phase_optimizers(torch) -> dict:
    """Each of adamw (bf16 first moment), rmsprop, sgd and sgd with
    momentum trains one epoch of 12 steps at full width through
    ``fit_arena`` on the train phase's seeded arenas, with ``_check_fit``'s
    checks. Then the trained model's gradient on one batch, and its
    float32 parameters, go through the optimizer's first update on the
    card and on the CPU: parameters held to 2^-20 of |p| + |update|
    (a few float32 ulps), float32 state likewise, a bf16 moment to one
    bf16 ulp."""
    import numpy as np

    from skin_image_analysis_tpu_torch import config as cfg_lib
    from skin_image_analysis_tpu_torch.train import loop
    from skin_image_analysis_tpu_torch.train.state import make_optimizer
    from skin_image_analysis_tpu_torch.train.step import (
        masked_loss_and_metrics,
    )

    dev = torch.device("cuda")
    lr = 1e-4
    n_train = BATCH * K * CALLS
    lines = {}
    for name, fields in OPTIMIZERS.items():
        cfg = cfg_lib.TrainConfig(
            epochs=1, seed=0,
            data=cfg_lib.DataConfig(image_size=CROP, canonical_size=SIZE,
                                    batch_size=BATCH, augment=True,
                                    steps_per_dispatch=K),
            model=cfg_lib.ModelConfig(compute_dtype="bfloat16",
                                      image_size=CROP),
            optim=cfg_lib.OptimConfig(learning_rate=lr, **fields))
        result, launches, wall, train_arena, _ = _fit(
            torch, cfg, n_train, TEST_ROWS, seed=1)
        losses, steps = _check_fit(result, launches, cfg, n_train,
                                   TEST_ROWS)
        model = result.state.model
        train_pre = loop._preprocess_fns(cfg, cfg.model,
                                         loop._default_augment(cfg))[0]
        gen = torch.Generator(dev).manual_seed(11)
        rows = torch.arange(BATCH, dtype=torch.int32, device=dev)
        labels = torch.from_numpy(
            np.random.default_rng(11).integers(0, 2, BATCH)).to(dev)
        model.train()
        log_probs = model(train_pre(train_arena, gen, rows=rows),
                          train=True, generator=gen)
        loss, _, _ = masked_loss_and_metrics(log_probs, labels)
        params = list(model.parameters())
        grads = torch.autograd.grad(loss, params)
        card = [p.detach().clone() for p in params]
        cpu = [p.detach().cpu() for p in params]
        old = [p.detach().cpu() for p in params]
        opt_card = make_optimizer(cfg.optim, card)
        opt_cpu = make_optimizer(cfg.optim, cpu)
        opt_card.step([g.detach().clone() for g in grads])
        opt_cpu.step([g.detach().cpu() for g in grads])
        worst = 0.0
        for got, want, before in zip(card, cpu, old):
            diff = (got.cpu() - want).abs()
            tol = 2.0 ** -20 * (before.abs() + (want - before).abs())
            if not (diff <= tol).all():
                raise AssertionError(f"{name}: the first update on the card "
                                     f"differs from the CPU's by "
                                     f"{float(diff.max())}")
            worst = max(worst, float(diff.max()))
        state_err = 0.0
        for key, tensors in opt_card.state().items():
            for got, want in zip(tensors, opt_cpu.state()[key]):
                diff = (got.cpu().float() - want.float()).abs()
                tol = (bf16_tol(want) if want.dtype == torch.bfloat16
                       else 2.0 ** -20 * want.abs().float())
                if not (diff <= tol).all():
                    raise AssertionError(f"{name}: {key} on the card differs "
                                         f"from the CPU's by "
                                         f"{float(diff.max())}")
                state_err = max(state_err, float(diff.max()))
        lines[name] = {
            "steps": steps, "launches": launches,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "wall_s": wall, "first_update_max_abs_diff": worst,
            "state_max_abs_diff": state_err,
            "accuracy": result.records[-1]["accuracy"],
        }
        del result, model, train_arena, card, cpu, old, grads
        torch.cuda.empty_cache()
    line = {"phase": "optimizers", "batch": BATCH, "lr": lr,
            "optimizers": lines,
            "launches": sum(v["launches"] for v in lines.values()),
            "held": "|card - cpu| <= 2^-20 (|p| + |update|); bf16 state 1 "
                    "bf16 ulp"}
    emit(line)
    return line


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return _worker(json.loads(sys.argv[2]))
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

    seconds = {}

    def timed(name, phase, *args):
        t = time.perf_counter()
        out = phase(torch, *args)
        seconds[name] = time.perf_counter() - t
        return out

    card = timed("card", phase_card)
    kernel_lines = timed("kernels", phase_kernels, BATCH, ARENA_ROWS, SIZE,
                         CROP)
    conv_lines = {ln["kernel"]: ln
                  for ln in timed("convblock", phase_convblock, BATCH, CROP)}
    from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel \
        as bk

    from skin_image_analysis_tpu_torch.ops.kernels import depthwise_kernel \
        as dk

    bn_lines = timed("batchnorm", phase_batchnorm)
    dw_lines = timed("depthwise", phase_depthwise)
    bn_entries = (bk.batchnorm_train_forward, bk.batchnorm_backward,
                  bk.batchnorm_eval_forward, dk.depthwise_forward,
                  dk.depthwise_backward)
    bn_before = [fn.launches for fn in bn_entries]
    train = timed("train", phase_train)
    if [fn.launches for fn in bn_entries] != bn_before:
        raise AssertionError("the flagship's fit launched BatchNorm or "
                             "depthwise kernels")
    pconv0 = timed("pconv0", phase_pconv0)
    timed("train_s2d", phase_train_s2d)
    timed("train_1024", phase_train_1024)
    switch = timed("preprocess_switch", phase_preprocess_switch)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        jpeg = timed("jpeg", phase_jpeg, work)
        root = os.path.join(work, "cohort")
        os.makedirs(root)
        t0 = time.perf_counter()
        frames = _write_cohort(root, COHORT_ROWS, seed=6)
        write_s = time.perf_counter() - t0
        cli, ctx = timed("cli", phase_cli, work, root, frames, write_s)
        del frames
        streaming = timed("streaming", phase_streaming, work, root, ctx)
        hostfeed = timed("hostfeed", phase_hostfeed, work, root)
        elastic = timed("elastic", phase_elastic, work, root)
        timed("predict", phase_predict, ctx)
        tools = timed("cli_tools", phase_cli_tools, work, root, ctx, cli)
        migrate = timed("migrate", phase_migrate, work, root, ctx)
        transfer = timed("transfer", phase_transfer, work, root)
        xception = timed("xception", phase_xception, work, root)
        ita = timed("ita", phase_ita, work, root)
        families = timed("families", phase_families, work, root)
        timed("explain", phase_explain, work, ctx)
        timed("serve", phase_serve, work, ctx)
        timed("quantize", phase_quantize, work, ctx)
        hpo = timed("hpo", phase_hpo, work)
        parallel = timed("parallel", phase_parallel, work, root, ctx)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    optimizers = timed("optimizers", phase_optimizers)
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
    emit({"phase": "kernels", "table": [
        {"name": name, "replaces": site, "source": source,
         "status": "ported, held against its plain version"}
        for name, site, source in TPU_KERNELS]})
    # the train step runs the tail with bf16 output, and the pconv0 path
    # the conv0 forward on float32 x: report those variants; the
    # preprocess kernel's launches are the main path's: the JPEG cohort's
    # train CLI and tone classifier, the train CLI (run and resume), the
    # streamed run, both feeds of run_training, the
    # elastic run, the cli_tools runs (profiled, checked, and the NaN
    # run's one step), the imported folder's epoch, the optimizers' fits,
    # both transfer runs, the xception run, the ITA run, the family runs,
    # the hpo phase (its waves, lone runs and CLI), the parallel phase
    # (its processes' runs and steps, resnet18's data-parallel steps among
    # them, and the split wave) and the "on" fit of preprocess_switch
    main_variant = [ln for ln in kernel_lines
                    if ln["variant"] == "tail_bf16"][0]
    pre_launches = (jpeg["launches"] + jpeg["tone_classifier"]["launches"]
                    + cli["launches"] + cli["resume_launches"]
                    + streaming["launches"]
                    + sum(hostfeed["launches"].values())
                    + elastic["launches"] + tools["launches"]
                    + migrate["launches"] + optimizers["launches"]
                    + transfer["launches"] + transfer["frozen_launches"]
                    + xception["launches"] + ita["launches"]
                    + families["launches"] + hpo["launches"]
                    + parallel["launches"] + switch["launches"])
    rows = [
        (main_variant, pre_launches,
         max([ln["max_abs_err"] for ln in kernel_lines]
             + [transfer["preprocess"]["max_abs_err"],
                ita["preprocess"]["max_abs_err"]])),
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
        in zip(TPU_KERNELS, rows)]
        + _bn_kernel_rows(bn_lines, transfer["bn_launches"])
        + _dw_kernel_rows(dw_lines, xception["depthwise_launches"])})
    print(card["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

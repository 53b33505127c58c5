"""Per-layer timing rig for the port's train step (port of the JAX
package's ``tools/perf_attrib.py``).

Usage::

    python -m skin_image_analysis_tpu_torch.tools.perf_attrib [stage ...]
        [--batch-size 256] [--iters 20] [--scan-len 16] [--moments DTYPE]
        [--image-size 224] [--device cuda]

Stages (default: step scan fwd fwdbwd opt pre):

  step    one train step: the preprocess kernel gathers the batch from a
          planar uint8 arena, then forward, backward and the adam update
  scan    ``--scan-len`` steps in one ``multi_train_step`` call; per step
  fwd     preprocess + forward + loss, no gradient
  fwdbwd  preprocess + forward + backward (gradients, no update)
  opt     the adam update alone, on fixed gradients
  pre     the preprocess kernel alone, in the step's window (with its
          random draws)
  prebands  the preprocess kernel alone at 1, 2, 4 and 8 bands per image
          (``band_plan``), in each of its variants and in ``no_tail_bf16``
          (the bytes of ``tail_bf16`` without its arithmetic); device time
          by :func:`cuda_ms`
  blocks  each conv block forward and forward + backward, the stock pool
          forward + backward at each post-conv shape, and the MLP stack
  pools2  the pool variants at each post-conv shape
  pconv0  the fused phase-conv0 kernels (forward, forward + dW/db) against
          the unfused ``phase_packed_conv_block`` on the same inputs
  dwclusters  the phase-conv0 dW kernel alone at 1, 2, 4 and 8 blocks per
          image (``dw_plan``'s bands); device time by
          :func:`cuda_ms`
  fwdplans  the phase-conv0 forward kernel alone (float32 and bf16 x) at
          4, 8 and 16 pooled rows a tile, one block an SM (``fwd_plan``);
          device time by :func:`cuda_ms`
  cost    the train step's conv and matmul FLOPs (``utils.flops``)

Each timing prints one JSON line (``stage``, ``ms``, ``img_per_s``,
``note``, ``device``), and a ``summary`` line ends the run. On a CUDA
device a time is the median over 3 windows of ``--iters`` calls, each
window timed by CUDA events after 2 warm-up calls (``prebands``,
``dwclusters`` and ``fwdplans``: by :func:`cuda_ms`); on the CPU the same windows are
timed by the host clock, which says nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig
from skin_image_analysis_tpu_torch.models.cnn import stem_wants_s2d
from skin_image_analysis_tpu_torch.ops.preprocess import (
    AugmentConfig,
    make_preprocess_fn,
)
from skin_image_analysis_tpu_torch.train.loop import resolve_device
from skin_image_analysis_tpu_torch.train.state import create_train_state
from skin_image_analysis_tpu_torch.train.step import (
    masked_loss_and_metrics,
    multi_train_step,
    train_step,
)
from skin_image_analysis_tpu_torch.utils.profiling import SPAN_PREFIX

DEFAULT_STAGES = ("step", "scan", "fwd", "fwdbwd", "opt", "pre")
STAGES = DEFAULT_STAGES + ("prebands", "blocks", "pools2", "pconv0",
                           "dwclusters", "fwdplans", "cost")
WARMUP = 2
# cuda_ms's device spin: about 1 ms at the H100's 1.98 GHz boost clock,
# far longer than a kernel wrapper's host work
SPIN_CYCLES = 2_000_000
FLUSH_BYTES = 128 << 20  # read to evict the card's 50 MB L2 cache


def time_call(fn, iters: int, device: torch.device) -> float:
    """Median over 3 windows of the ms per call of ``fn()``, ``iters``
    calls a window, after :data:`WARMUP` calls: ``WARMUP + 3 * iters``
    calls in all."""
    for _ in range(WARMUP):
        fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return sorted(times)[1]


def l2_flusher(device: torch.device):
    """A function that evicts the card's L2 cache by reading a buffer of
    :data:`FLUSH_BYTES`. Reading, not writing: a zeroed buffer would leave
    its dirty lines in L2, for the timed kernel to write back inside its
    window."""
    buf = torch.ones(FLUSH_BYTES // 4, dtype=torch.int32, device=device)
    return buf.max


def cuda_ms(fn, iters: int, flush) -> float:
    """Median device time of ``fn()`` over ``iters`` runs, each preceded
    (outside the timed window) by ``flush()``.

    A 1 ms device spin sits between the flush and the start event, so the
    card is still busy while the host runs ``fn``'s Python (checks,
    allocations, the launch call) and enqueues the end event: the window
    then holds device time only, not host time during which the card
    waited for the launch."""
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_kernels(fn, sessions: int = 6) -> list:
    """The device kernels that one call of ``fn()`` launches, as
    torch.profiler's ``key_averages()`` entries (``count`` each); the
    device's copies of the program's spans (``utils.profiling.annotate``)
    are no kernels and are left out.

    ``fn`` must launch work on the card. A profiler session can lose all of
    its device records (the first of a process often does, a later one now
    and then), so the first session is discarded, and so is any later one
    that reports no device kernel, up to ``sessions`` more; the first that
    reports one is returned as it is. If none does, this raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for i in range(1 + sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and not ev.key.startswith(SPAN_PREFIX)]
        if i and evs:
            return evs
    raise RuntimeError(f"torch.profiler reported no device kernel in "
                       f"{sessions} sessions of a call that launches work "
                       f"on the card")


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


class Rig:
    """The rig's inputs, made from seeds on the chosen device, and the
    lines it has printed."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.dev = resolve_device(args.device)
        self.device_name = (torch.cuda.get_device_name(self.dev)
                            if self.dev.type == "cuda" else "cpu")
        self.b, self.side = args.batch_size, args.image_size
        self.model_cfg = ModelConfig(compute_dtype="bfloat16",
                                     image_size=self.side)
        self.state = create_train_state(
            self.model_cfg,
            OptimConfig(learning_rate=1e-5,
                        moment_dtype=args.moments or None),
            seed=0, device=self.dev)
        canonical = max(256, self.side)
        gen = torch.Generator(device=self.dev).manual_seed(0)
        self.arena = torch.randint(0, 256, (self.b, 3, canonical, canonical),
                                   dtype=torch.uint8, device=self.dev,
                                   generator=gen)
        self.rows = torch.arange(self.b, dtype=torch.int32, device=self.dev)
        self.labels = torch.randint(0, 2, (self.b,), device=self.dev,
                                    generator=gen)
        self.valid = torch.ones(self.b, dtype=torch.bool, device=self.dev)
        self.pre = make_preprocess_fn(
            self.side, train=True,
            augment=AugmentConfig(brightness=0.1, contrast=0.1,
                                  saturation=0.1),
            layout="planar", out_dtype=self.model_cfg.compute_dtype,
            space_to_depth=stem_wants_s2d(self.model_cfg))
        self.results: dict[str, float] = {}
        self.lines: list[dict] = []

    def time(self, fn) -> float:
        return time_call(fn, self.args.iters, self.dev)

    def calls(self) -> int:
        """How many calls :meth:`time` makes."""
        return WARMUP + 3 * self.args.iters

    def emit(self, name: str, ms: float, note: str = "", **extra) -> dict:
        self.results[name] = ms
        line = {"stage": name, "ms": ms, "img_per_s": self.b / ms * 1e3,
                "note": note, "device": self.device_name, **extra}
        return self.print(line)

    def print(self, line: dict) -> dict:
        self.lines.append(line)
        print(json.dumps(line), flush=True)
        return line

    def rand(self, shape, seed: int) -> torch.Tensor:
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        return torch.randn(shape, device=self.dev,
                           generator=gen).to(torch.bfloat16)

    def loss(self):
        st = self.state
        px = self.pre(self.arena, st.generator, rows=self.rows)
        st.model.train()
        log_probs = st.model(px, train=True, generator=st.generator)
        return masked_loss_and_metrics(log_probs, self.labels, self.valid)[0]


def stage_step(rig: Rig) -> None:
    st = rig.state
    ms = rig.time(lambda: train_step(st, rig.arena, rig.labels, rig.valid,
                                     None, rig.pre, rows=rig.rows))
    rig.emit("step", ms, "train step: preprocess kernel + fwd + bwd + adam")


def stage_scan(rig: Rig) -> None:
    k = rig.args.scan_len
    idx = np.tile(np.arange(rig.b, dtype=np.int32), (k, 1))
    labels = np.tile(rig.labels.cpu().numpy(), (k, 1))
    valid = np.ones((k, rig.b), bool)
    st = rig.state
    iters = max(rig.args.iters // 4, 3)
    ms = time_call(lambda: multi_train_step(st, rig.arena, idx, labels,
                                            valid, None, rig.pre),
                   iters, rig.dev)
    rig.emit("scan", ms / k, f"{k} steps in one multi_train_step call; "
             "per-step ms")


def stage_fwd(rig: Rig) -> None:
    def fwd():
        with torch.no_grad():
            return rig.loss()

    rig.emit("fwd", rig.time(fwd), "preprocess + forward + loss")


def stage_fwdbwd(rig: Rig) -> None:
    params = rig.state.optimizer.params
    ms = rig.time(lambda: torch.autograd.grad(rig.loss(), params))
    rig.emit("fwdbwd", ms, "preprocess + forward + backward (no update)")


def stage_opt(rig: Rig) -> None:
    opt = rig.state.optimizer
    grads = [torch.ones_like(p) for p in opt.params]
    n_par = sum(p.numel() for p in opt.params)
    rig.emit("opt", rig.time(lambda: opt.step(grads)),
             f"adam update, {n_par / 1e6:.1f}M params")


def stage_pre(rig: Rig) -> None:
    gen = rig.state.generator
    ms = rig.time(lambda: rig.pre(rig.arena, gen, rows=rig.rows))
    rig.emit("pre", ms, "uint8 gather/crop/flip/jitter/normalize kernel")


# name: (jitter tail, output dtype, space-to-depth store)
PRE_VARIANTS = {
    "tail_bf16": (True, torch.bfloat16, False),
    "s2d_tail_bf16": (True, torch.bfloat16, True),
    "tail_f32": (True, torch.float32, False),
    "no_tail_f32": (False, torch.float32, False),
    "no_tail_bf16": (False, torch.bfloat16, False),
}


def stage_prebands(rig: Rig) -> None:
    from skin_image_analysis_tpu_torch.ops.kernels import (
        preprocess_kernel as pk,
    )

    b, t = rig.b, rig.side
    gen = torch.Generator(device=rig.dev).manual_seed(4)

    def factor(shape):
        return 0.9 + 0.2 * torch.rand(shape, device=rig.dev, generator=gen)

    offsets = torch.randint(0, rig.arena.shape[-1] - t + 1, (b, 2),
                            dtype=torch.int32, device=rig.dev, generator=gen)
    flips = torch.randint(0, 2, (b,), dtype=torch.int32, device=rig.dev,
                          generator=gen)
    scale = (factor((b, 1)) / 255).expand(b, 3).contiguous()
    bias = torch.zeros(b, 3, device=rig.dev)
    tail = (factor((b,)), factor((b,)), factor((b, 3)), factor((b, 3)) - 1)
    if rig.dev.type == "cuda":
        flush = l2_flusher(rig.dev)

        def timed(fn):
            return cuda_ms(fn, rig.args.iters, flush)
    else:
        timed = rig.time
    saved = pk.CLUSTER_BLOCKS, pk.PLAIN_BLOCKS
    try:
        for blocks in (1, 2, 4, 8):
            pk.CLUSTER_BLOCKS = pk.PLAIN_BLOCKS = blocks
            for name, (has_tail, dtype, s2d) in PRE_VARIANTS.items():
                def call(has_tail=has_tail, dtype=dtype, s2d=s2d):
                    return pk.fused_preprocess_planar(
                        rig.arena, offsets, flips, scale, bias, rig.rows,
                        *(tail if has_tail else (None,) * 4), image_size=t,
                        out_dtype=dtype, space_to_depth=s2d)

                rig.emit(f"pre_{name}_k{blocks}", timed(call),
                         f"preprocess kernel alone, {blocks} bands per image")
    finally:
        pk.CLUSTER_BLOCKS, pk.PLAIN_BLOCKS = saved


def _pool_shapes(side: int):
    return [(side, 32), (side // 2, 64), (side // 4, 128)]


def stage_blocks(rig: Rig) -> None:
    s0 = rig.side
    block_in = [(s0, 3), (s0 // 2, 32), (s0 // 4, 64)]
    for i, (blk, (s_in, c_in)) in enumerate(
            zip(rig.state.model.conv_blocks, block_in)):
        xin = rig.rand((rig.b, c_in, s_in, s_in), 3 + i)
        params = list(blk.parameters())

        def fwd(blk=blk, xin=xin):
            with torch.no_grad():
                return blk(xin)

        rig.emit(f"conv{i}_fwd", rig.time(fwd))
        xg = xin.detach().requires_grad_(True)

        def fwdbwd(blk=blk, xg=xg, params=params):
            return torch.autograd.grad(blk(xg).float().sum(), [xg, *params])

        rig.emit(f"conv{i}_fwdbwd", rig.time(fwdbwd),
                 "grads wrt params AND input")

    for s_io, c in _pool_shapes(s0):
        xg = rig.rand((rig.b, c, s_io, s_io), 10).requires_grad_(True)

        def pool_fwdbwd(xg=xg):
            return torch.autograd.grad(F.max_pool2d(xg, 2, 2).float().sum(),
                                       xg)

        rig.emit(f"pool{s_io}x{c}_fwdbwd", rig.time(pool_fwdbwd))

    model = rig.state.model
    flat = rig.rand((rig.b, (s0 // 8) ** 2 * 128), 11)
    mlp_params = [p for m in (*model.mlp_blocks, model.head)
                  for p in m.parameters()]

    def mlp_fwdbwd():
        h = flat
        for layer in model.mlp_blocks:
            h = F.relu(layer(h))
        lp = F.log_softmax(model.head(h).float(), dim=-1)
        return torch.autograd.grad(lp.sum(), mlp_params)

    rig.emit("mlp_fwdbwd", rig.time(mlp_fwdbwd),
             "flatten MLP + head, grads wrt params")


def stage_pools2(rig: Rig) -> None:
    from skin_image_analysis_tpu_torch.ops.pooling import (
        max_pool_2x2,
        max_pool_2x2_hybrid,
        relu_max_pool_2x2,
    )

    def grad_of(fn, xg):
        return lambda: torch.autograd.grad(fn(xg).float().sum(), xg)

    for s_io, c in _pool_shapes(rig.side):
        xin = rig.rand((rig.b, c, s_io, s_io), 5)
        xg = xin.detach().requires_grad_(True)
        tag = f"{s_io}x{c}"

        def fused_fwd(xin=xin):
            with torch.no_grad():
                return relu_max_pool_2x2(xin)

        rig.emit(f"fusedpool{tag}_fwd", rig.time(fused_fwd))
        rig.emit(f"fusedpool{tag}_fwdbwd",
                 rig.time(grad_of(relu_max_pool_2x2, xg)),
                 "ReLU + pool, uint8-selector backward")
        rig.emit(f"stockpool{tag}_fwd",
                 rig.time(lambda xin=xin: F.max_pool2d(F.relu(xin), 2, 2)))
        rig.emit(f"maxpool{tag}_fwdbwd", rig.time(grad_of(max_pool_2x2, xg)),
                 "reshape-max forward, equality-mask backward")
        rig.emit(f"hybridpool{tag}_fwdbwd",
                 rig.time(grad_of(max_pool_2x2_hybrid, xg)),
                 "F.max_pool2d forward, equality-mask backward")


def stage_pconv0(rig: Rig) -> None:
    from skin_image_analysis_tpu_torch.ops.kernels.convblock_kernel import (
        fused_phase_conv0,
    )
    from skin_image_analysis_tpu_torch.ops.pooling import (
        phase_packed_conv_block,
    )

    # the JAX rig's inputs: numpy seed 7, x planar float32, w HWIO * 0.1
    rng = np.random.default_rng(7)
    b, s = rig.b, rig.side
    x = torch.from_numpy(rng.standard_normal(
        (b, 3, s, s), np.float32)).to(rig.dev)
    w = torch.from_numpy(np.ascontiguousarray(
        (rng.standard_normal((7, 7, 3, 32), np.float32) * 0.1)
        .transpose(3, 2, 0, 1))).to(rig.dev).requires_grad_(True)
    bias = torch.zeros(32, device=rig.dev, requires_grad=True)
    xb = x.to(torch.bfloat16)

    def unfused(w, bias):
        return phase_packed_conv_block(xb, w.to(torch.bfloat16),
                                       bias.to(torch.bfloat16))

    def grads(fn):
        return torch.autograd.grad(fn().float().sum(), (w, bias))

    fused_grads = grads(lambda: fused_phase_conv0(x, w, bias))
    unfused_grads = grads(lambda: unfused(w, bias))
    cos = {"grad_cos_dw": _cos(fused_grads[0], unfused_grads[0]),
           "grad_cos_db": _cos(fused_grads[1], unfused_grads[1])}

    def fused_fwd():
        with torch.no_grad():
            return fused_phase_conv0(x, w, bias)

    def unfused_fwd():
        with torch.no_grad():
            return unfused(w, bias)

    calls = rig.calls()
    rig.emit("pconv0_fwd", rig.time(fused_fwd),
             "fused phase-conv0 forward kernel", calls=calls)
    rig.emit("pconv0_fwdbwd",
             rig.time(lambda: grads(lambda: fused_phase_conv0(x, w, bias))),
             "fused forward + dW kernel + db (no dx)", calls=calls,
             grad_check_calls=1, **cos)
    rig.emit("uconv0_fwd", rig.time(unfused_fwd),
             "unfused phase_packed_conv_block forward (cuDNN on the card)")
    rig.emit("uconv0_fwdbwd",
             rig.time(lambda: grads(lambda: unfused(w, bias))),
             "unfused forward + dW/db")


def stage_dwclusters(rig: Rig) -> None:
    from skin_image_analysis_tpu_torch.ops.kernels import (
        convblock_kernel as ck,
    )

    gen = torch.Generator(device=rig.dev).manual_seed(8)
    b, s = rig.b, rig.side
    x = torch.randn((b, 3, s, s), device=rig.dev, generator=gen)
    wp2 = ck._pack_w(0.1 * torch.randn((32, 3, 7, 7), device=rig.dev,
                                       generator=gen))
    bias4 = torch.zeros(128, device=rig.dev)
    xb = x.to(torch.bfloat16)
    _, sel = ck.fused_phase_conv0_fwd(xb, wp2, bias4)
    g = torch.randn(sel.shape, device=rig.dev,
                    generator=gen).to(torch.bfloat16)
    if rig.dev.type == "cuda":
        flush = l2_flusher(rig.dev)

        def timed(fn):
            return cuda_ms(fn, rig.args.iters, flush)
    else:
        timed = rig.time
    bands = ck.dw_plan(s, b, sms=0)  # its bands; the cluster replaced
    for cluster in (1, 2, 4, 8):
        plan = bands._replace(cluster=cluster)
        rig.emit(f"dw_s{cluster}",
                 timed(lambda: ck.fused_phase_conv0_dw(xb, g, sel, plan)),
                 f"phase-conv0 dW kernel alone, {cluster} blocks per image")


def stage_fwdplans(rig: Rig) -> None:
    from skin_image_analysis_tpu_torch.ops.kernels import (
        convblock_kernel as ck,
    )

    gen = torch.Generator(device=rig.dev).manual_seed(9)
    b, s = rig.b, rig.side
    x32 = torch.randn((b, 3, s, s), device=rig.dev, generator=gen)
    wp2 = ck._pack_w(0.1 * torch.randn((32, 3, 7, 7), device=rig.dev,
                                       generator=gen))
    bias4 = 0.05 * torch.randn(128, device=rig.dev, generator=gen)
    if rig.dev.type == "cuda":
        flush = l2_flusher(rig.dev)

        def timed(fn):
            return cuda_ms(fn, rig.args.iters, flush)
    else:
        timed = rig.time
    for rows in (4, 8, 16):
        smem = ck.fwd_smem_bytes(rows, s)
        if smem > ck.SMEM_LIMIT:
            continue
        plan = ck.FwdPlan(rows, 1, smem)
        for tag, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16))):
            rig.emit(f"fwd_r{rows}_{tag}",
                     timed(lambda: ck.fused_phase_conv0_fwd(x, wp2, bias4,
                                                            plan)),
                     f"phase-conv0 forward kernel alone, {rows} pooled rows "
                     f"a tile, one block an SM")


def stage_cost(rig: Rig) -> None:
    from skin_image_analysis_tpu_torch.utils.flops import (
        forward_flops_per_img,
    )

    per_img = forward_flops_per_img(rig.model_cfg)
    rig.print({"stage": "cost", "flops": 3.0 * per_img * rig.b,
               "forward_flops_per_img": per_img,
               "note": "conv and matmul FLOPs of one train step (3x the "
                       "forward, utils/flops.py); torch has no count of "
                       "bytes accessed",
               "device": rig.device_name})


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m skin_image_analysis_tpu_torch.tools.perf_attrib",
        description="Per-layer timings of the port's train step.")
    p.add_argument("stages", nargs="*",
                   help=f"stages to run, of {' '.join(STAGES)} (default: "
                        f"{' '.join(DEFAULT_STAGES)})")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--scan-len", type=int, default=16)
    p.add_argument("--moments", default="",
                   help="adam moment dtype override (e.g. bfloat16)")
    p.add_argument("--image-size", type=int, default=224,
                   help="model input H = W (arena frames max(256, this))")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    unknown = sorted(set(args.stages) - set(STAGES))
    if unknown:
        p.error(f"unknown stages {unknown}; choose from {' '.join(STAGES)}")
    return args


def run(argv=None) -> list[dict]:
    """Run the stages ``argv`` names and return the lines printed."""
    args = parse_args(argv)
    stages = args.stages or list(DEFAULT_STAGES)
    rig = Rig(args)
    for name in STAGES:
        if name in stages:
            globals()[f"stage_{name}"](rig)
    if rig.results:
        rig.print({"stage": "summary", "batch_size": rig.b,
                   "device": rig.device_name, **rig.results})
    return rig.lines


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Wave-structured parallel HPO over the full reference search space (port
of the JAX package's ``hpo.wave``).

The reference runs 100 independent Optuna trials as MPI ranks
(README.md:54). Stacked trials must share tensor shapes, so the sweep
runs as *waves* of rolling lanes:

1. each wave samples the architecture skeleton once, (n_conv_layers,
   n_linear_layers, optimizer), through the study's sampler;
2. the wave's K lanes each host a trial that samples its widths, dropout
   rates, lr and its OWN 300-row data sample (the reference's per-trial
   resample), and train in lockstep as one padded super-network
   population (``hpo.population``);
3. every trial reports per-epoch validation accuracy through the median
   pruner; a pruned or finished trial's lane is refilled mid-wave with a
   fresh same-skeleton trial (a masked lane merge), so pruning frees real
   compute. The wave ends when every lane's trial is finished.

The preprocess: the JAX package's wave converts each step's gathered
``[K, B]`` uint8 rows with ``/ 255`` once for the whole stack, not once
per trial. The port runs that gather and conversion as ONE launch of the
fused preprocess kernel per stacked train step (and one per validation
batch), over all K lanes' rows (``population.stacked_input``).

With ``mesh=`` (an in-process ``parallel.create_mesh``, or any
``Mesh`` over local devices) the wave's lane axis splits over the mesh's
devices: K is rounded to a multiple of their count (the extra lanes are
fillers, trained but never registered with or told to the study, as in
the JAX package), each device runs one ``torch.func.vmap`` group of K/N
lanes with no cross-lane traffic, and the pool is copied to each device
once. The dropout draws are made for all K lanes from the one generator
on the first device and split, so each lane trains as it would on one
device.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from skin_image_analysis_tpu_torch.config import HpoConfig
from skin_image_analysis_tpu_torch.hpo.population import (
    WavePrograms,
    WaveSkeleton,
    _microbatching,
    max_population,
    planar_pool,
    wave_masks,
)
from skin_image_analysis_tpu_torch.hpo.space import MAX_EXTRA_CONV_LAYERS
from skin_image_analysis_tpu_torch.hpo.study import (
    Study,
    Trial,
    TrialState,
    create_study,
)


def mesh_devices(mesh, device) -> list[torch.device]:
    """The devices a lane axis splits over: every device of an in-process
    ``mesh``, or ``device`` alone without one."""
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    if mesh is None:
        return [resolve_device(device)]
    if mesh.is_process_mesh:
        raise TypeError("the HPO lanes split over an in-process mesh "
                        "(create_mesh(cfg, devices=...))")
    return [resolve_device(d) for d in mesh.local_devices]


class LaneShards:
    """K lanes split evenly over ``devices``: the lane slice, the
    programs and the pool of each device (one copy per distinct
    device)."""

    def __init__(self, devices, k: int, skel: WaveSkeleton, microbatch: int,
                 n_micro: int, pools: dict):
        g = k // len(devices)
        self.devices = devices
        self.slices = [slice(i * g, (i + 1) * g) for i in range(len(devices))]
        progs: dict = {}
        self.progs = [progs.setdefault(d, WavePrograms(skel, microbatch,
                                                       n_micro, d))
                      for d in devices]
        self.pools = [pools[d] for d in devices]

    def split(self, a) -> list[torch.Tensor]:
        """A per-lane array (leading K axis) as each device's slice."""
        return [torch.as_tensor(a[sl]).to(d)
                for d, sl in zip(self.devices, self.slices)]

    def split_noise(self, noise: list) -> list[list]:
        """One step's ``[K, ...]`` dropout draws as each device's lanes."""
        return [[[t[sl].to(d) for t in micro] for micro in noise]
                for d, sl in zip(self.devices, self.slices)]


def _suggest_non_skeleton(t, n_conv: int, n_linear: int,
                          width_range: tuple = (16, 256)):
    """Sample the per-lane parameters (widths, dropouts, lr) of a trial
    whose skeleton is fixed."""
    lo, hi = width_range
    t.suggest_int("first_conv_out", lo, hi)
    for j in range(n_conv):
        t.suggest_int(f"conv_out_{j}", lo, hi)
    for j in range(n_linear):
        t.suggest_int(f"linear_out_{j}", lo, hi)
    for j in range(n_linear):
        t.suggest_float(f"dropout_{j}", 0.2, 0.5)
    t.suggest_float("lr", 1e-5, 1e-1, log=True)
    return t


def _lane_vectors(t, n_conv: int, n_linear: int):
    conv = [t.params["first_conv_out"]] + [
        t.params[f"conv_out_{j}"] for j in range(n_conv)]
    lin = [t.params[f"linear_out_{j}"] for j in range(n_linear)]
    dr = [t.params[f"dropout_{j}"] for j in range(n_linear)]
    return conv, lin, dr, t.params["lr"]


def run_wave_study(
    pixels: np.ndarray,
    labels: np.ndarray,
    cfg: HpoConfig = HpoConfig(),
    image_size: int | None = None,
    compute_dtype: str = "bfloat16",
    study: Study | None = None,
    wave_size: int | None = None,
    mesh=None,
    verbose: bool = True,
    width_range: tuple = (16, 256),
    device="cuda",
) -> tuple[Study, dict[str, Any]]:
    """Run ~cfg.trials trials as rolling-lane waves on ``device``, or with
    the lane axis split over the devices of ``mesh``; returns (study,
    stats). ``pixels`` are uint8 NHWC at the model's size. stats: waves,
    trials, elapsed_s, refills, lane_epochs (epochs run x lanes),
    live_lane_epochs (epochs spent on unfinished trials), and
    ``preprocess_launches`` (kernel launches of the run; 0 on the CPU,
    where the plain twin runs)."""
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )

    devices = mesh_devices(mesh, device)
    n_dev = len(devices)
    if image_size is None:
        image_size = pixels.shape[1]
    study = study or create_study("maximize")
    max_pools = max(1, image_size.bit_length() - 1)
    max_extra = max(1, min(MAX_EXTRA_CONV_LAYERS, max_pools - 1))

    # the whole cohort goes to each device once; every trial's sample is
    # an index gather against this pool
    pools = {}
    for d in devices:
        if d not in pools:
            pools[d] = (planar_pool(pixels, d), torch.as_tensor(
                np.asarray(labels).astype(np.int64), device=d))
    launches0 = fused_preprocess_planar.launches

    start = time.time()
    deadline = start + cfg.time_limit_hours * 3600
    waves = refills = lane_epochs = live_lane_epochs = 0
    n_sample = min(cfg.sample_size, len(labels))
    cut = int(2 / 3 * n_sample)

    while len(study.trials) < cfg.trials and time.time() < deadline:
        probe = study.ask()
        n_conv = probe.suggest_int("n_conv_layers", 1, max_extra)
        n_linear = probe.suggest_int("n_linear_layers", 2, 5)
        optimizer = probe.suggest_categorical(
            "optimizer", ["adam", "rmsprop", "sgd"])
        skel = WaveSkeleton(
            n_conv=n_conv, n_linear=n_linear, optimizer=optimizer,
            image_size=image_size, compute_dtype=compute_dtype,
            pad_width=width_range[1])
        skel_params = dict(probe.params)
        k = min(wave_size or cfg.population or 8,
                max_population(skel, cfg.batch_size),
                cfg.trials - len(study.trials) + 1)
        k = max(k, 1)
        n_real = k
        if mesh is not None:
            # the lane axis splits over the mesh: K must divide evenly
            cap = max_population(skel, cfg.batch_size)
            if cap < n_dev:
                raise ValueError(
                    f"skeleton {skel} fits only {cap} padded lanes but "
                    f"the mesh has {n_dev} devices")
            k = max(n_dev, (k // n_dev) * n_dev)
            # lanes past the remaining-trial budget ride as fillers, never
            # registered or told, so the study stays an honest N-trial run
            n_real = min(n_real, k)
        microbatch, n_micro = _microbatching(skel, cfg.batch_size, None)

        n_tb = cut // cfg.batch_size
        if cfg.n_train_examples:
            n_tb = min(n_tb, max(cfg.n_train_examples // cfg.batch_size, 1))
        avail_v = n_sample - cut
        mb_eval = min(microbatch, max(avail_v, 1))
        n_vb = avail_v // mb_eval
        if cfg.n_valid_examples:
            n_vb = min(n_vb, max(cfg.n_valid_examples // mb_eval, 1))
        if n_tb < 1 or n_vb < 1:
            raise ValueError(
                f"cohort of {len(labels)} rows (sample {n_sample}, "
                f"2/3 train cut {cut}) cannot fill one train batch of "
                f"{cfg.batch_size} plus one validation row — need at "
                f"least ~{cfg.batch_size * 3 // 2} rows or a smaller "
                "--batch-size")

        rng = np.random.default_rng(cfg.seed + 31 * waves)

        def new_lane_trial(ask_probe=None, filler=False):
            t = ask_probe
            if t is None:
                t = Trial(study, -1, study.sampler) if filler \
                    else study.ask()
                t.params.update(skel_params)
            _suggest_non_skeleton(t, n_conv, n_linear, width_range)
            sample = rng.permutation(len(labels))[:n_sample]
            return {
                "trial": t,
                "vec": _lane_vectors(t, n_conv, n_linear),
                "tr_rows": sample[:n_tb * cfg.batch_size],
                "va_rows": sample[cut:cut + n_vb * mb_eval],
                "birth": 0,
                "live": True,
                "filler": filler,
                "key": rng.integers(0, 2**31),
            }

        lanes = ([new_lane_trial(probe)]
                 + [new_lane_trial() for _ in range(n_real - 1)]
                 + [new_lane_trial(filler=True) for _ in range(k - n_real)])
        wave_trials = n_real  # at most 2k a wave: the skeleton adapts

        conv_w = np.zeros((k, 1 + n_conv), np.int64)
        lin_w = np.zeros((k, n_linear), np.int64)
        drops = np.zeros((k, n_linear), np.float32)
        lrs = np.zeros((k,), np.float32)
        vb_idx = np.zeros((k, n_vb, mb_eval), np.int64)

        def load_lane(ti, lane):
            conv, lin, dr, lr = lane["vec"]
            conv_w[ti] = conv
            lin_w[ti] = lin
            drops[ti] = dr
            lrs[ti] = lr
            vb_idx[ti] = lane["va_rows"].reshape(n_vb, mb_eval)

        for ti, lane in enumerate(lanes):
            load_lane(ti, lane)

        shards = LaneShards(devices, k, skel, microbatch, n_micro,
                            {d: p for d, (p, _) in pools.items()})
        pool_lbs = [pools[d][1] for d in devices]

        def commit():
            """Each device's lane arrays (again after a refill)."""
            out = []
            for arrays in zip(*(shards.split(a) for a in (
                    conv_w, lin_w, drops, lrs, vb_idx))):
                t = dict(zip(("conv_w", "lin_w", "drops", "lrs", "vb"),
                             arrays))
                t["masks"] = wave_masks(skel, t["conv_w"], t["lin_w"])
                out.append(t)
            return out

        def init(seeds, dd):
            """Each device's stacked params and optimizer state; lane k
            draws from a generator seeded with ``seeds[k]``."""
            states = [p.init_wave(seeds[sl], t["conv_w"], t["lin_w"])
                      for p, sl, t in zip(shards.progs, shards.slices, dd)]
            return [s[0] for s in states], [s[1] for s in states]

        d = commit()
        params, opt = init([(cfg.seed + waves) * 1009 + i for i in range(k)],
                           d)

        max_wave_epochs = 2 * cfg.epochs
        gen = torch.Generator(device=devices[0]).manual_seed(
            cfg.seed + 1000 + waves)
        t0 = time.time()
        epoch = 0
        while any(lane["live"] for lane in lanes):
            tb_idx = shards.split(np.stack([
                np.random.default_rng(lane["key"] + epoch)
                .permutation(lane["tr_rows"])
                .reshape(n_tb, cfg.batch_size)
                for lane in lanes]))
            for i in range(n_tb):
                noise = shards.split_noise(
                    shards.progs[0].draw_noise(k, gen))
                for j, progs in enumerate(shards.progs):
                    params[j], opt[j], _ = progs.train_step(
                        params[j], opt[j], shards.pools[j], pool_lbs[j],
                        tb_idx[j][:, i], d[j]["masks"], d[j]["drops"],
                        d[j]["lrs"], noise[j])
            accs = np.concatenate([
                progs.valid_accuracy(params[j], shards.pools[j],
                                     pool_lbs[j], d[j]["vb"]).cpu().numpy()
                for j, progs in enumerate(shards.progs)])
            lane_epochs += k
            live_lane_epochs += sum(lane["live"] for lane in lanes)

            refill_mask = np.zeros(k, bool)
            for ti, lane in enumerate(lanes):
                if not lane["live"]:
                    continue
                local = epoch - lane["birth"]
                trial = lane["trial"]
                done = local >= cfg.epochs - 1
                if lane["filler"]:
                    pruned = False  # fillers never report
                else:
                    trial.report(float(accs[ti]), local)
                    pruned = not done and trial.should_prune()
                if not (done or pruned):
                    continue
                if not lane["filler"]:
                    study.tell(trial, float(accs[ti]),
                               TrialState.COMPLETE if done
                               else TrialState.PRUNED)
                can_refill = (
                    len(study.trials) < cfg.trials
                    and wave_trials < 2 * k
                    and epoch + 1 + cfg.epochs <= max_wave_epochs
                    and time.time() < deadline)
                if can_refill:
                    fresh = new_lane_trial()
                    fresh["birth"] = epoch + 1
                    lanes[ti] = fresh
                    load_lane(ti, fresh)
                    refill_mask[ti] = True
                    refills += 1
                    wave_trials += 1
                else:
                    lane["live"] = False

            if time.time() >= deadline:
                # the time budget ran out mid-wave: every live trial ends
                # pruned at its last report
                for ti, lane in enumerate(lanes):
                    if not lane["live"]:
                        continue
                    lane["live"] = False
                    if lane["filler"]:
                        continue
                    if lane["birth"] > epoch:
                        # refilled this epoch and never trained
                        study.trials.remove(lane["trial"])
                        refills -= 1
                        continue
                    study.tell(lane["trial"], float(accs[ti]),
                               TrialState.PRUNED)
                epoch += 1
                break
            if refill_mask.any():
                d = commit()
                fresh = init([cfg.seed + 7000 + waves * 100 + epoch * 1009 + i
                              for i in range(k)], d)
                masks = shards.split(refill_mask)
                params = [WavePrograms.merge_lanes(p, f, m) for p, f, m in
                          zip(params, fresh[0], masks)]
                opt = [WavePrograms.merge_lanes(o, f, m) for o, f, m in
                       zip(opt, fresh[1], masks)]
            epoch += 1
        wave_s = time.time() - t0
        waves += 1
        if verbose:
            best = max((t.value for t in study.completed_trials
                        if t.value is not None), default=float("nan"))
            print(f"wave {waves}: skeleton=({n_conv}conv,{n_linear}lin,"
                  f"{optimizer}) K={k} epochs={epoch} {wave_s:.1f}s "
                  f"best_so_far={best:.4f}")

    stats = {
        "waves": waves,
        "trials": len(study.trials),
        "elapsed_s": time.time() - start,
        "refills": refills,
        "lane_epochs": lane_epochs,
        "live_lane_epochs": live_lane_epochs,
        "preprocess_launches": fused_preprocess_planar.launches - launches0,
    }
    return study, stats

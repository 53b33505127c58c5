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

One device only: a mesh above 1 is refused (ROADMAP queue 1 item 12).
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
    TrialState,
    create_study,
)

MESH_UNPORTED = ("a mesh above 1 device is not ported yet (ROADMAP queue 1 "
                 "item 12, parallel/)")


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
    """Run ~cfg.trials trials as rolling-lane waves on ``device``;
    returns (study, stats). ``pixels`` are uint8 NHWC at the model's
    size. stats: waves, trials, elapsed_s, refills, lane_epochs (epochs
    run x lanes), live_lane_epochs (epochs spent on unfinished trials),
    and ``preprocess_launches`` (kernel launches of the run; 0 on the
    CPU, where the plain twin runs)."""
    from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
        fused_preprocess_planar,
    )
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    if mesh is not None and int(mesh) > 1:
        raise NotImplementedError(MESH_UNPORTED)
    dev = resolve_device(device)
    if image_size is None:
        image_size = pixels.shape[1]
    study = study or create_study("maximize")
    max_pools = max(1, image_size.bit_length() - 1)
    max_extra = max(1, min(MAX_EXTRA_CONV_LAYERS, max_pools - 1))

    # the whole cohort goes to the device once; every trial's sample is
    # an index gather against this pool
    pool = planar_pool(pixels, dev)
    pool_lb = torch.as_tensor(np.asarray(labels).astype(np.int64),
                              device=dev)
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

        def new_lane_trial(ask_probe=None):
            t = ask_probe
            if t is None:
                t = study.ask()
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
                "key": rng.integers(0, 2**31),
            }

        lanes = [new_lane_trial(probe)] + [new_lane_trial()
                                           for _ in range(k - 1)]
        wave_trials = k  # at most 2k a wave: the skeleton keeps adapting

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

        def commit():
            """The lane arrays on the device (again after a refill)."""
            t = {name: torch.as_tensor(a, device=dev) for name, a in (
                ("conv_w", conv_w), ("lin_w", lin_w), ("drops", drops),
                ("lrs", lrs), ("vb", vb_idx))}
            t["masks"] = wave_masks(skel, t["conv_w"], t["lin_w"])
            return t

        d = commit()
        progs = WavePrograms(skel, microbatch, n_micro, dev)
        params, opt = progs.init_wave(
            [(cfg.seed + waves) * 1009 + i for i in range(k)],
            d["conv_w"], d["lin_w"])

        max_wave_epochs = 2 * cfg.epochs
        gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1000
                                                      + waves)
        t0 = time.time()
        epoch = 0
        while any(lane["live"] for lane in lanes):
            tb_idx = torch.as_tensor(np.stack([
                np.random.default_rng(lane["key"] + epoch)
                .permutation(lane["tr_rows"])
                .reshape(n_tb, cfg.batch_size)
                for lane in lanes]), device=dev)
            for i in range(n_tb):
                params, opt, _ = progs.train_step(
                    params, opt, pool, pool_lb, tb_idx[:, i], d["masks"],
                    d["drops"], d["lrs"], progs.draw_noise(k, gen))
            accs = progs.valid_accuracy(params, pool, pool_lb,
                                        d["vb"]).cpu().numpy()
            lane_epochs += k
            live_lane_epochs += sum(lane["live"] for lane in lanes)

            refill_mask = np.zeros(k, bool)
            for ti, lane in enumerate(lanes):
                if not lane["live"]:
                    continue
                local = epoch - lane["birth"]
                trial = lane["trial"]
                done = local >= cfg.epochs - 1
                trial.report(float(accs[ti]), local)
                pruned = not done and trial.should_prune()
                if not (done or pruned):
                    continue
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
                fresh = progs.init_wave(
                    [cfg.seed + 7000 + waves * 100 + epoch * 1009 + i
                     for i in range(k)], d["conv_w"], d["lin_w"])
                m = torch.as_tensor(refill_mask, device=dev)
                params = WavePrograms.merge_lanes(params, fresh[0], m)
                opt = WavePrograms.merge_lanes(opt, fresh[1], m)
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

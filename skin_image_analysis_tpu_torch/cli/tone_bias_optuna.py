"""The HPO sweep CLI of the port (counterpart of the JAX package's
``cli.tone_bias_optuna``; the reference's tone_bias_optuna.py:291-343)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_optuna \\
        [<image root>] [--trials N] [--hours H] [--sample-size N]
        [--population K] [--parallel K] [--epochs N] [--batch-size N]
        [--seed N] [--image-size N] [--sampler tpe|random] [--mesh N]
        [--device cuda|cpu]

Runs the architecture search over a sample of the tone dataset with
median pruning, prints the pruned and complete counts and the best
parameters, and writes ``optuna_<trials>_<epochs>_<device>_<batch>_
<sample>.json`` in the working directory. ``--parallel K`` runs the sweep
as waves of K stacked trials (``hpo.wave``); ``--population K`` then
trains a stacked learning-rate population of the best architecture
(``hpo.parallel``). Without an image root it runs on synthetic separable
data. ``--mesh N`` splits each wave's lanes over the first N cards (N
positions on the CPU with ``--device cpu``); it needs ``--parallel K``.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from skin_image_analysis_tpu_torch.cli._common import (
    init_runtime,
    local_mesh,
    parse,
)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(
        argv,
        {"trials": 100, "hours": 16.0, "sample-size": 300,
         "population": 0, "epochs": 10, "batch-size": 32, "seed": 0,
         "image-size": 224, "sampler": "tpe", "parallel": 0, "mesh": 0,
         "device": "cuda"},
    )
    init_runtime(opts["device"])
    root = positional[0] if positional else None

    from skin_image_analysis_tpu_torch.config import HpoConfig
    from skin_image_analysis_tpu_torch.hpo import create_study
    from skin_image_analysis_tpu_torch.hpo.objective import make_objective
    from skin_image_analysis_tpu_torch.hpo.study import RandomSampler
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    dev = resolve_device(opts["device"])
    cfg = HpoConfig(
        trials=int(opts["trials"]),
        time_limit_hours=float(opts["hours"]),
        sample_size=int(opts["sample-size"]),
        batch_size=int(opts["batch-size"]),
        epochs=int(opts["epochs"]),
        population=int(opts["population"]),
        seed=int(opts["seed"]),
    )

    image_size = int(opts["image-size"])
    if root:
        from skin_image_analysis_tpu_torch.data.dataset import LesionTable
        from skin_image_analysis_tpu_torch.data.ingest import (
            read_isic_metadata,
        )
        from skin_image_analysis_tpu_torch.data.loader import HostImageStore

        df = read_isic_metadata(root, seed=cfg.seed)
        table = LesionTable(df, root)
        store = HostImageStore(table, canonical_size=image_size)
        pixels = np.ascontiguousarray(store.images.transpose(0, 2, 3, 1))
        labels = table.labels
    else:
        # smoke mode: synthetic separable data
        rng = np.random.default_rng(cfg.seed)
        labels = rng.integers(0, 2, 256).astype(np.int32)
        pixels = (rng.normal(0, 0.05, (256, image_size, image_size, 3))
                  + labels[:, None, None, None] * 0.6 + 0.2)
        pixels = (np.clip(pixels, 0, 1) * 255).astype(np.uint8)

    if opts["sampler"] == "tpe":
        from skin_image_analysis_tpu_torch.hpo.tpe import TPESampler

        sampler = TPESampler(cfg.seed)
    else:
        sampler = RandomSampler(cfg.seed)
    study = create_study("maximize", sampler=sampler)

    start = time.time()
    stats = None
    wave_size = int(opts["parallel"])
    if int(opts["mesh"]) > 1 and wave_size <= 1:
        raise SystemExit(
            "--mesh shards the parallel wave's lane axis and needs "
            "--parallel K (K a multiple of the mesh size); without it "
            "the sweep would silently run single-device"
        )
    if wave_size > 1:
        from skin_image_analysis_tpu_torch.hpo.wave import run_wave_study

        study, stats = run_wave_study(
            pixels, labels, cfg, image_size=image_size, study=study,
            wave_size=wave_size, device=dev,
            mesh=local_mesh(int(opts["mesh"]), opts["device"]))
        print(f"waves: {stats['waves']}  trials: {stats['trials']}  "
              f"refills: {stats['refills']}  lane-epochs "
              f"{stats['live_lane_epochs']}/{stats['lane_epochs']} live")
    else:
        objective = make_objective(pixels, labels, cfg,
                                   image_size=image_size, device=dev)
        study.optimize(objective, n_trials=cfg.trials,
                       timeout=cfg.time_limit_hours * 3600)
    elapsed = time.time() - start

    print(f"Study statistics:  ({elapsed:.1f}s)")
    print(f"  Number of finished trials: {len(study.trials)}")
    print(f"  Number of pruned trials: {len(study.pruned_trials)}")
    print(f"  Number of complete trials: {len(study.completed_trials)}")
    best = study.best_trial
    print(f"Best trial value: {best.value}")
    print("Best params:")
    for k, v in best.params.items():
        print(f"    {k}: {v}")

    out_name = (f"optuna_{cfg.trials}_{cfg.epochs}_{dev.type}_"
                f"{cfg.batch_size}_{cfg.sample_size}.json")
    with open(out_name, "w") as f:
        json.dump({
            "best_value": best.value,
            "best_params": best.params,
            "trials": cfg.trials,
            "epochs": cfg.epochs,
            "device": dev.type,
            "batch_size": cfg.batch_size,
            "sample_size": cfg.sample_size,
            "image_size": image_size,
            "elapsed_s": elapsed,
            "n_pruned": len(study.pruned_trials),
            "n_complete": len(study.completed_trials),
            **({
                "waves": stats["waves"],
                "refills": stats["refills"],
                "lane_epochs": stats["lane_epochs"],
                "live_lane_epochs": stats["live_lane_epochs"],
            } if stats else {}),
        }, f, indent=2)
    print(f"Wrote {out_name}")

    if cfg.population > 1:
        from skin_image_analysis_tpu_torch.hpo.parallel import (
            train_population,
        )
        from skin_image_analysis_tpu_torch.hpo.space import define_isic_model
        from skin_image_analysis_tpu_torch.hpo.study import TrialReplay

        model_cfg, _ = define_isic_model(TrialReplay(best.params),
                                         image_size=image_size)
        lrs = np.geomspace(1e-5, 1e-1, cfg.population)
        cut = int(2 / 3 * len(labels))
        out = train_population(
            model_cfg, lrs, pixels[:cut], labels[:cut], pixels[cut:],
            labels[cut:], epochs=cfg.epochs, batch_size=cfg.batch_size,
            seed=cfg.seed, device=dev)
        print("Population sweep (lr -> final val acc):")
        for lr, acc in zip(lrs, out["final_accuracy"]):
            print(f"    {lr:.2e} -> {float(acc):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

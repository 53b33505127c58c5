"""The training CLI of the port (counterpart of the JAX package's
``cli.tone_bias_train``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_train \\
        <image root> <epochs> <'balance'|'imbalanced'|experiment folder>

The same positionals and flags as the JAX package's CLI: ``--seed``,
``--batch-size``, ``--lr``, ``--optimizer adam|adamw|rmsprop|sgd``,
``--augment``,
``--fp32``/``--bf16``, ``--image-size``, ``--model``, ``--init-from``,
``--class-weights ''|auto|w0,w1``, the ``--lr-*`` schedule flags,
``--moment-dtype``, ``--nu-dtype``, ``--steps-per-dispatch``,
``--checkpoint-every N``, ``--keep-best <metric>``, ``--early-stop N``
and ``--auto-resume N`` (on a crash, resume the folder's remaining
epochs, up to N restarts; it snapshots every epoch unless
``--checkpoint-every`` says otherwise). One more, ``--device`` (``cuda`` by default, ``cpu`` for the plain
versions on the CPU). New runs go under ``results/`` in the working
directory.

``--from-hpo <artifact>`` trains the winning configuration of a sweep
artifact, ours (``tone_bias_optuna``) or the reference's ``optuna_*.json``
(``hpo.replay``): the architecture, the optimizer kind and the lr come
from it, every other flag still applies.

``--profile <dir>`` records the whole run with ``torch.profiler`` and
writes a Chrome trace JSON under ``<dir>`` (``utils.profiling.trace``).
``--debug-nans`` runs it under ``train.step.debug_nans``: anomaly mode
over every backward, and each train step's model input, log-probs, loss
and gradients and each eval batch's log-probs checked, every step of a
multi-step call on its own; the first non-finite value raises
FloatingPointError naming the step and the tensor. It cannot see a NaN
that appears and vanishes inside one operation or one CUDA kernel, or a
NaN in a masked branch. Neither flag changes the device or the kernels
the run uses.

``--streaming`` streams both splits in chunks of ``--chunk-size`` rows
(2048 by default, a multiple of ``--batch-size``) instead of decoding
them whole (``data.streaming``); ``--stream-cache`` keeps the decoded
frames in the folder's ``stream_cache_{train,test}_{S}.npy``, so later
epochs and a resume decode nothing.

Under ``torchrun`` (or with ``SIA_COORDINATOR``, ``SIA_NUM_PROCESSES``
and ``SIA_PROCESS_ID`` set) each process is one rank of a data-parallel
run (``parallel.distributed``): one card a rank, ``--batch-size`` the
global batch, rank 0 writing the folder.
"""

from __future__ import annotations

import contextlib
import os
import sys

from skin_image_analysis_tpu_torch.cli._common import init_runtime, parse
from skin_image_analysis_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from skin_image_analysis_tpu_torch.train.loop import (
    run_training,
    run_training_elastic,
)
from skin_image_analysis_tpu_torch.train.step import debug_nans
from skin_image_analysis_tpu_torch.utils.profiling import trace

def _optim_config(lr: float, class_weights: str, opts: dict) -> OptimConfig:
    """--class-weights '' (off) | 'auto' (balanced from the train split) |
    'w0,w1'; --optimizer and the lr-schedule flags map to OptimConfig."""
    kw = dict(
        learning_rate=lr,
        **({"optimizer": opts["optimizer"]} if opts["optimizer"] else {}),
        lr_schedule=opts["lr-schedule"],
        lr_step_size=opts["lr-step-size"],
        lr_gamma=opts["lr-gamma"],
        lr_decay_steps=opts["lr-decay-steps"],
        lr_warmup_steps=opts["lr-warmup-steps"],
        moment_dtype=opts["moment-dtype"] or None,
        nu_dtype=opts["nu-dtype"] or None,
    )
    if class_weights == "auto":
        return OptimConfig(auto_class_weights=True, **kw)
    if class_weights:
        kw["class_weights"] = tuple(float(w) for w in class_weights.split(","))
    return OptimConfig(**kw)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(
        argv,
        {"seed": 0, "batch-size": 16, "lr": 1e-5, "init-from": "",
         "model": "skin_cancer_list", "image-size": 224, "profile": "",
         "chunk-size": 2048, "class-weights": "", "lr-schedule": "",
         "lr-step-size": 0, "lr-gamma": 0.1, "lr-decay-steps": 0,
         "lr-warmup-steps": 0, "moment-dtype": "", "nu-dtype": "",
         "optimizer": "", "steps-per-dispatch": 8, "auto-resume": 0,
         "checkpoint-every": 0, "from-hpo": "", "keep-best": "",
         "early-stop": 0, "device": "cuda"},
        bool_flags={"augment", "fp32", "bf16", "debug-nans", "streaming",
                    "stream-cache"},
    )
    if len(positional) != 3:
        print("Usage: <root directory of ISIC images> <number of epochs> "
              "<'balance' or 'imbalanced' | path to existing model>")
        print("Example: tone 20 balance")
        return 1
    init_runtime(opts["device"])
    root, epochs, mode = positional[0], int(positional[1]), positional[2]
    balance = "imbalanced" not in mode
    experiment_dir = mode if os.path.exists(mode) else (
        mode if mode not in ("balance", "balanced", "imbalanced") else None)
    auto_resume = opts["auto-resume"]
    checkpoint_every = opts["checkpoint-every"]
    if auto_resume > 0 and checkpoint_every == 0:
        # recovery an epoch at a time needs a snapshot each epoch
        checkpoint_every = 1
    cfg = TrainConfig(
        epochs=epochs,
        experiment_dir=experiment_dir,
        init_from=opts["init-from"] or None,
        checkpoint_every=checkpoint_every,
        checkpoint_best=bool(opts["keep-best"]),
        best_metric=opts["keep-best"] or "loss",
        early_stop_patience=int(opts["early-stop"]),
        seed=opts["seed"],
        data=DataConfig(
            root_dir=root, balance=balance, batch_size=opts["batch-size"],
            augment=opts["augment"], seed=opts["seed"],
            image_size=opts["image-size"],
            canonical_size=max(256, opts["image-size"]),
            streaming=opts["streaming"],
            chunk_size=opts["chunk-size"],
            stream_cache=opts["stream-cache"],
            steps_per_dispatch=opts["steps-per-dispatch"],
        ),
        model=ModelConfig(
            name=opts["model"], image_size=opts["image-size"],
            compute_dtype="float32" if opts["fp32"] else "bfloat16",
        ),
        optim=_optim_config(opts["lr"], opts["class-weights"], opts),
    )
    if opts["from-hpo"]:
        import dataclasses

        from skin_image_analysis_tpu_torch.hpo.replay import replay_artifact

        model_cfg, optim_cfg = replay_artifact(
            opts["from-hpo"], image_size=opts["image-size"],
            compute_dtype=cfg.model.compute_dtype)
        cfg = dataclasses.replace(
            cfg, model=model_cfg,
            optim=dataclasses.replace(
                cfg.optim, optimizer=optim_cfg.optimizer,
                learning_rate=optim_cfg.learning_rate))
        print(f"from-hpo: conv={model_cfg.conv_features} "
              f"linear={model_cfg.linear_features} "
              f"dropout={tuple(round(d, 3) for d in model_cfg.dropout)} "
              f"{optim_cfg.optimizer} lr={optim_cfg.learning_rate:g}")
    with contextlib.ExitStack() as stack:
        if opts["debug-nans"]:
            stack.enter_context(debug_nans())
        if opts["profile"]:
            stack.enter_context(trace(
                opts["profile"], device=opts["device"].startswith("cuda")))
        if auto_resume > 0:
            folder = run_training_elastic(cfg, retries=auto_resume,
                                          device=opts["device"])
        else:
            folder = run_training(cfg, device=opts["device"])
    print(f"Experiment folder: {folder}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The training loop over decoded planar uint8 arenas (port of the epoch
loop of the JAX package's ``train.loop.run_training``).

:func:`fit_arena` is the port's entry point: it trains ``cfg.epochs``
epochs from a train arena, ``steps_per_dispatch`` steps per call, runs one
eval pass over the test arena per epoch and appends one JSON-lines
fairness record per epoch to ``out_dir``. The epoch order and its padding
follow the JAX package's ``BatchIterator.super_batches``: a seeded numpy
shuffle, the last call padded with inert all-invalid steps, eval rows
padded with ``row_id`` -1.

Not ported yet: file ingest and decode, resume, keep-best, early stop,
checkpoints, the device mesh and streaming; configs that ask for them are
refused.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Iterator, Mapping

import numpy as np
import torch

from skin_image_analysis_tpu_torch import config as config_lib
from skin_image_analysis_tpu_torch.config import TrainConfig
from skin_image_analysis_tpu_torch.models.cnn import stem_wants_s2d
from skin_image_analysis_tpu_torch.ops.preprocess import (
    AugmentConfig,
    make_preprocess_fn,
)
from skin_image_analysis_tpu_torch.train.evaluate import evaluate_fairness
from skin_image_analysis_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)
from skin_image_analysis_tpu_torch.train.step import multi_train_step
from skin_image_analysis_tpu_torch.utils import jsonl

_DI_KEYS = ("tone_di_results", "gender_di_results", "control_di_results")
#: keys of every per-epoch record fit_arena writes
RECORD_KEYS = (
    "correct", "total", "accuracy", "dark", "light", "male", "female",
    *_DI_KEYS, "auc", "tone_accuracy_dark", "tone_accuracy_light",
    "tone_accuracy_gap", "auc_dark", "auc_light", "avg_batch_loss",
    "train_accuracy", "epoch", "epoch_time_s", "eval_time_s",
)


@dataclasses.dataclass
class FitResult:
    """What :func:`fit_arena` trained and measured. ``step_*`` hold one
    array per epoch with one entry per step, 0 for inert padding steps."""

    state: TrainState
    records: list[dict]
    results_path: str
    step_losses: list[np.ndarray]
    step_correct: list[np.ndarray]
    step_counts: list[np.ndarray]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


def _pad_to(n: int, arr: np.ndarray, fill=0) -> np.ndarray:
    if len(arr) == n:
        return arr
    pad = np.full((n - len(arr), *arr.shape[1:]), fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def super_batches(
    order: np.ndarray, labels: np.ndarray, batch_size: int, k: int,
    drop_remainder: bool, with_row_ids: bool = False,
) -> Iterator[tuple[np.ndarray, ...]]:
    """An epoch in ``order`` as ``[k, B]`` (idx, label, valid) calls, or
    (idx, row_id, valid) with ``with_row_ids``; the arena row is the row
    id. The last call is padded with all-invalid steps, a partial last
    batch (without ``drop_remainder``) with invalid rows of row id -1."""
    bs = batch_size
    n = len(order)
    n_batches = n // bs if drop_remainder else -(-n // bs)
    idx_all = (order[: n_batches * bs] if drop_remainder
               else _pad_to(n_batches * bs, order))
    valid_all = np.zeros(n_batches * bs, bool)
    valid_all[: min(n, n_batches * bs)] = True
    idx_all = idx_all.reshape(n_batches, bs).astype(np.int32)
    valid_all = valid_all.reshape(n_batches, bs)
    if with_row_ids:
        second = np.where(valid_all, idx_all, -1).astype(np.int32)
        fill = -1
    else:
        second = np.asarray(labels)[idx_all].astype(np.int32)
        fill = 0
    for start in range(0, n_batches, k):
        ib = idx_all[start : start + k]
        sb = second[start : start + k]
        vd = valid_all[start : start + k]
        if len(ib) < k:
            pad = k - len(ib)
            ib = np.concatenate([ib, np.zeros((pad, bs), np.int32)])
            sb = np.concatenate([sb, np.full((pad, bs), fill, np.int32)])
            vd = np.concatenate([vd, np.zeros((pad, bs), bool)])
        yield ib, sb, vd


def balanced_class_weights(labels: np.ndarray, n_classes: int = 2):
    """sklearn's 'balanced' weights n_samples / (n_classes * n_c)."""
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=n_classes).astype(np.float64)
    if (counts == 0).any():
        raise ValueError(f"empty class in labels: counts={counts}")
    return labels.size / (n_classes * counts)


def _refuse_unported(cfg: TrainConfig) -> None:
    unported = {
        "data.streaming": cfg.data.streaming,
        "checkpoint_every": cfg.checkpoint_every,
        "checkpoint_best": cfg.checkpoint_best,
        "early_stop_patience": cfg.early_stop_patience,
        "experiment_dir": cfg.experiment_dir,
        "init_from": cfg.init_from,
    }
    asked = [k for k, v in unported.items() if v]
    if cfg.data.pallas_preprocess != "auto":
        # the augmented train step always runs the preprocess kernel
        asked.append(f"data.pallas_preprocess={cfg.data.pallas_preprocess!r}")
    if asked:
        raise NotImplementedError(f"not ported yet: {', '.join(asked)}")


def _as_arena(arena, dev: torch.device) -> torch.Tensor:
    arena = torch.as_tensor(arena).to(dev)
    if arena.dtype != torch.uint8 or arena.dim() != 4 \
            or arena.shape[2] != arena.shape[3]:
        raise ValueError("arenas must be [N, C, S, S] uint8")
    return arena.contiguous()


def fit_arena(
    cfg: TrainConfig,
    train_arena,
    train_labels: np.ndarray,
    test_arena,
    test_labels: np.ndarray,
    test_group_codes: Mapping[str, np.ndarray],
    out_dir: str,
    device="cuda",
    augment: AugmentConfig | None = None,
) -> FitResult:
    """Train on the planar uint8 ``train_arena`` ([N, 3, S, S], numpy or
    torch) and audit on ``test_arena`` every ``cfg.eval_every`` epochs.

    ``test_group_codes`` maps skin_tone, sex and control to per-row codes
    (-1 = missing). ``augment`` defaults to the JAX package's recipe when
    ``cfg.data.augment`` (flip, random crop, jitter 0.1 each), else none.
    Writes ``train_config.json`` and ``<timestamp>.json`` records into
    ``out_dir``."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    train_arena = _as_arena(train_arena, dev)
    test_arena = _as_arena(test_arena, dev)
    train_labels = np.asarray(train_labels)
    test_labels = np.asarray(test_labels)
    if len(train_labels) != train_arena.shape[0] \
            or len(test_labels) != test_arena.shape[0]:
        raise ValueError("one label per arena row")

    model_cfg = cfg.model
    if model_cfg.image_size != cfg.data.image_size:
        # the flatten dense fixes the input size: the model's wins
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, image_size=model_cfg.image_size))
    state = create_train_state(model_cfg, cfg.optim, cfg.seed, dev)

    if augment is None and cfg.data.augment:
        augment = AugmentConfig(brightness=0.1, contrast=0.1, saturation=0.1)
    # an s2d-stem model takes the layout from the kernel's store; eval
    # hands the model plain NHWC, which it transforms itself
    train_pre = make_preprocess_fn(
        cfg.data.image_size, train=True, augment=augment,
        normalize_imagenet=cfg.data.normalize_imagenet,
        input_affine=cfg.data.input_affine, layout="planar",
        out_dtype=model_cfg.compute_dtype,
        space_to_depth=stem_wants_s2d(model_cfg),
    )
    eval_pre = make_preprocess_fn(
        cfg.data.image_size, train=False,
        normalize_imagenet=cfg.data.normalize_imagenet,
        input_affine=cfg.data.input_affine, layout="planar",
    )
    class_weights = cfg.optim.class_weights
    if cfg.optim.auto_class_weights and class_weights is None:
        class_weights = tuple(balanced_class_weights(train_labels))

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train_config.json"), "w") as f:
        f.write(config_lib.to_json(cfg))
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    results_path = os.path.join(out_dir, f"{stamp}.json")

    bs, k = cfg.data.batch_size, max(1, cfg.data.steps_per_dispatch)
    order_rng = np.random.default_rng(cfg.data.seed + 1)
    result = FitResult(state, [], results_path, [], [], [])
    for epoch in range(cfg.epochs):
        epoch_start = time.time()
        order = np.arange(train_arena.shape[0])
        order_rng.shuffle(order)
        metrics = [
            multi_train_step(state, train_arena, ib, lb, vd, class_weights,
                             train_pre)
            for ib, lb, vd in super_batches(order, train_labels, bs, k,
                                            cfg.data.drop_remainder)
        ]
        losses = torch.cat([m["loss"] for m in metrics]).cpu().numpy()
        corr = torch.cat([m["correct"] for m in metrics]).cpu().numpy()
        counts = torch.cat([m["count"] for m in metrics]).cpu().numpy()
        live = counts > 0
        avg_batch_loss = float(losses[live].mean()) if live.any() else 0.0
        train_accuracy = int(corr.sum()) / max(int(counts.sum()), 1)
        epoch_time = time.time() - epoch_start
        result.step_losses.append(losses)
        result.step_correct.append(corr)
        result.step_counts.append(counts)

        if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
            eval_start = time.time()
            batches = super_batches(
                np.arange(test_arena.shape[0]), test_labels, bs, k,
                drop_remainder=False, with_row_ids=True)
            record = evaluate_fairness(state.model, test_arena, batches,
                                       test_labels, test_group_codes,
                                       eval_pre)
            record["avg_batch_loss"] = avg_batch_loss
            record["train_accuracy"] = train_accuracy
            record["epoch"] = epoch
            record["epoch_time_s"] = epoch_time
            record["eval_time_s"] = time.time() - eval_start
            jsonl.append_record(results_path, record)
            result.records.append(record)
    return result

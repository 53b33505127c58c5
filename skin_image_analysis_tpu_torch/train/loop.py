"""The training driver: experiment folder, epoch loop, fairness eval,
checkpoints and resume (port of the JAX package's ``train.loop``).

Two entry points share one epoch loop:

- :func:`run_training` is the flagship run the train CLI drives: ingest
  ``<root>/metadata.csv``, balance and split it (or reload the frozen
  splits of an experiment folder), decode both splits once into planar
  uint8 arenas on the card, train ``cfg.epochs`` epochs with one fairness
  record per epoch, and keep the folder: ``session_train.csv``,
  ``session_test.csv``, ``train_config.json``, ``<timestamp>.json``
  records, ``session_model.msgpack`` (the JAX package's format),
  ``checkpoint/`` (the port's full train state) and the progress marker.
  Resume, ``init_from``, ``checkpoint_every``, keep-best and early stop
  behave as in the JAX package.
- :func:`fit_arena` trains from arenas a caller already holds, into an
  output directory, without the folder's options.

:func:`run_training_elastic` supervises :func:`run_training`, resuming
the folder after a crash (the ``SIA_FAULT_ONCE`` hook injects one).

The epoch order and its padding follow the JAX package's
``BatchIterator``: a seeded numpy shuffle (``seed + 1``, restarted by each
run), eval rows padded with ``row_id`` -1, rows whose decode failed
invalid. A split whose arena lives on the card runs ``k`` steps a call
from it, the last call padded with inert all-invalid steps. A split that
does not (``device_cache=False``, both arenas above
``device_cache_max_bytes``, or an upload that runs out of device memory)
is fed host batches by a ``BatchIterator``, one step a batch, as the JAX
package does. With ``data.streaming`` both splits stream in chunks
(``data.streaming.ChunkedBatchIterator``, the JAX package's seeds), one
step a batch, the preprocess kernel gathering each batch's rows from the
chunk on the card; ``data.stream_cache`` keeps the decoded frames in the
folder's ``stream_cache_{train,test}_{S}.npy``.

Under a ``torch.distributed`` process group (``parallel.distributed.
maybe_initialize``) both entry points train on a process mesh
(``parallel.create_mesh(cfg.mesh)``): every rank holds the whole arena
(or streams the whole chunks) and trains its rows of each global batch
(``batch_size`` must divide over the data axis, with the JAX package's
error), the flatten Dense split over the model axis when it has more than
one rank. Rank 0 broadcasts the initial parameters once. Rank 0 alone
writes the experiment folder (records, ``session_model.msgpack``, the
checkpoint, the progress marker, the stream cache), the split weights
gathered whole first, so the folder has the single-process layout; the
other ranks wait at a barrier at the end (and, with the stream cache,
after every epoch: they read the cache once rank 0 has filled it), and a
resume reads the folder on every rank. The JAX package's loop has no such rule (its processes
share one program); the write rule is the port's own.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob
import os
import time
from typing import Iterator, Mapping

import numpy as np
import torch
import torch.distributed as dist

from skin_image_analysis_tpu_torch import config as config_lib
from skin_image_analysis_tpu_torch.config import ModelConfig, TrainConfig
from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.ingest import (
    balance_dataset,
    read_csv,
    read_isic_metadata,
    shuffle_split,
)
from skin_image_analysis_tpu_torch.data.loader import (
    BatchIterator,
    HostImageStore,
)
from skin_image_analysis_tpu_torch.data.streaming import (
    ChunkedBatchIterator,
    cache_file,
)
from skin_image_analysis_tpu_torch.models.cnn import stem_wants_s2d
from skin_image_analysis_tpu_torch.ops.preprocess import (
    AugmentConfig,
    make_preprocess_fn,
)
from skin_image_analysis_tpu_torch.parallel.mesh import create_mesh
from skin_image_analysis_tpu_torch.parallel.tensor import (
    full_state_dict,
    full_train_state,
    shard_train_state,
)
from skin_image_analysis_tpu_torch.toneclassifier.class_weight import (
    balanced_class_weights,
)
from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib
from skin_image_analysis_tpu_torch.train.evaluate import (
    batch_pixels,
    evaluate_fairness,
)
from skin_image_analysis_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)
from skin_image_analysis_tpu_torch.train.step import (
    multi_train_step,
    train_step,
)
from skin_image_analysis_tpu_torch.utils import jsonl
from skin_image_analysis_tpu_torch.utils.profiling import annotate

TRAIN_SET_FILENAME = "session_train.csv"
TEST_SET_FILENAME = "session_test.csv"
CHECKPOINT_DIRNAME = "checkpoint"
PROGRESS_FILENAME = "epochs_completed.log"
#: metrics keep-best and early stop can track: 'loss' is the train
#: average batch loss (lower is better, every epoch); the rest are keys of
#: the eval record (higher is better, eval epochs only)
_BEST_METRICS = ("loss", "avg_batch_loss", "accuracy", "auc",
                 "auc_dark", "auc_light")

_DI_KEYS = ("tone_di_results", "gender_di_results", "control_di_results")
#: keys of every per-epoch record
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
    row_ok: np.ndarray | None = None,
) -> Iterator[tuple[np.ndarray, ...]]:
    """An epoch in ``order`` as ``[k, B]`` (idx, label, valid) calls, or
    (idx, row_id, valid) with ``with_row_ids``; the arena row is the row
    id. The last call is padded with all-invalid steps, a partial last
    batch (without ``drop_remainder``) with invalid rows of row id -1.
    Rows where ``row_ok`` is False are invalid too."""
    bs = batch_size
    n = len(order)
    n_batches = n // bs if drop_remainder else -(-n // bs)
    idx_all = (order[: n_batches * bs] if drop_remainder
               else _pad_to(n_batches * bs, order))
    valid_all = np.zeros(n_batches * bs, bool)
    kept = min(n, n_batches * bs)
    valid_all[:kept] = True if row_ok is None else row_ok[order[:kept]]
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


def _refuse_folder_options(cfg: TrainConfig) -> None:
    """Refuse the options of an experiment folder (run_training's) in
    fit_arena, which keeps none."""
    folder_options = {
        "checkpoint_every": cfg.checkpoint_every,
        "checkpoint_best": cfg.checkpoint_best,
        "early_stop_patience": cfg.early_stop_patience,
        "experiment_dir": cfg.experiment_dir,
        "init_from": cfg.init_from,
        "data.streaming": cfg.data.streaming,
    }
    asked = [k for k, v in folder_options.items() if v]
    if asked:
        raise NotImplementedError(
            f"fit_arena keeps no experiment folder: {', '.join(asked)} are "
            "options of run_training")


def _process_mesh(cfg: TrainConfig, device):
    """(mesh, device): the process mesh of ``cfg.mesh`` and this rank's
    device under a process group, else (None, ``device``)."""
    if not dist.is_initialized():
        return None, resolve_device(device)
    mesh = create_mesh(cfg.mesh)
    if mesh.device.type != torch.device(device).type:
        raise ValueError(
            f"the process group computes on {mesh.device}, the run asks for "
            f"{device!r}")
    dp = mesh.shape[cfg.mesh.data_axis]
    if cfg.data.batch_size % dp:
        raise ValueError(
            f"batch_size {cfg.data.batch_size} not divisible by data-"
            f"parallel degree {dp}"
        )
    return mesh, mesh.device


def _is_writer(mesh) -> bool:
    """Whether this process writes the run's files: rank 0 of a mesh."""
    return mesh is None or dist.get_rank() == 0


def _distribute(state: TrainState, mesh, cfg: TrainConfig) -> None:
    """Rank 0's parameters and buffers on every rank, then the model-axis
    split of the flatten Dense (``parallel.tensor``)."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in (*state.model.parameters(), *state.model.buffers()):
            dist.broadcast(t, src=0)
    shard_train_state(state, mesh, cfg.mesh.model_axis)


def _save_model(path: str, model_cfg: ModelConfig, state: TrainState,
                mesh) -> None:
    """``session_model`` from rank 0, the split weights gathered whole
    (a collective: every rank calls it)."""
    sd = state.model.state_dict() if mesh is None else full_state_dict(
        state.model)
    if _is_writer(mesh):
        ckpt_lib.save_model(path, model_cfg, sd)


def _save_state(ckpt_dir: str, state: TrainState, mesh) -> None:
    """The snapshot from rank 0, gathered whole (a collective)."""
    full = state if mesh is None else full_train_state(state)
    if _is_writer(mesh):
        ckpt_lib.save_train_state(ckpt_dir, full)


def _as_arena(arena, dev: torch.device) -> torch.Tensor:
    arena = torch.as_tensor(arena).to(dev)
    if arena.dtype != torch.uint8 or arena.dim() != 4 \
            or arena.shape[2] != arena.shape[3]:
        raise ValueError("arenas must be [N, C, S, S] uint8")
    return arena.contiguous()


def _preprocess_fns(cfg: TrainConfig, model_cfg: ModelConfig,
                    augment: AugmentConfig | None):
    """(train, eval) preprocess over the planar arenas, as the JAX
    package's loop makes them: ``data.pallas_preprocess`` chooses the
    train path's kernel ("auto": with augmentation; "on": every train
    call; "off": none), eval keeps the plain resize. An s2d-stem model
    takes its layout from the kernel's store; eval hands the model plain
    NHWC. The JAX loop's "hwc" arenas (without the kernel) hold the same
    pixels in another order: the port's arenas are planar always."""
    train_pre = make_preprocess_fn(
        cfg.data.image_size, train=True, augment=augment,
        normalize_imagenet=cfg.data.normalize_imagenet,
        input_affine=cfg.data.input_affine, layout="planar",
        out_dtype=model_cfg.compute_dtype,
        space_to_depth=stem_wants_s2d(model_cfg),
        pallas=cfg.data.pallas_preprocess,
    )
    eval_pre = make_preprocess_fn(
        cfg.data.image_size, train=False,
        normalize_imagenet=cfg.data.normalize_imagenet,
        input_affine=cfg.data.input_affine, layout="planar",
    )
    return train_pre, eval_pre


def _default_augment(cfg: TrainConfig) -> AugmentConfig | None:
    if cfg.data.augment:
        return AugmentConfig(brightness=0.1, contrast=0.1, saturation=0.1)
    return None


def _class_weights(cfg: TrainConfig, train_labels: np.ndarray):
    if cfg.optim.auto_class_weights and cfg.optim.class_weights is None:
        return tuple(balanced_class_weights(train_labels))
    return cfg.optim.class_weights


def _train_epoch(state, cfg, arena, order, labels, row_ok, class_weights,
                 train_pre, mesh=None):
    """One epoch in ``order`` from the device ``arena``: per-step (losses,
    correct, counts, live) on the host, fetched once. The inert padding
    steps are not live."""
    bs, k = cfg.data.batch_size, max(1, cfg.data.steps_per_dispatch)
    metrics = [
        multi_train_step(state, arena, ib, lb, vd, class_weights, train_pre,
                         mesh=mesh, data_axis=cfg.mesh.data_axis)
        for ib, lb, vd in super_batches(order, labels, bs, k,
                                        cfg.data.drop_remainder,
                                        row_ok=row_ok)
    ]
    losses, corr, counts = (
        torch.cat([m[key] for m in metrics]).cpu().numpy()
        for key in ("loss", "correct", "count"))
    return losses, corr, counts, counts > 0


def _loader_step(state, batch: dict, class_weights, train_pre, mesh,
                 data_axis: str) -> dict:
    """One train step on a loader batch: the preprocess kernel gathers a
    streamed batch's rows from its chunk, a host batch comes whole."""
    par = {} if mesh is None else {"mesh": mesh, "data_axis": data_axis}
    if "arena" in batch and getattr(train_pre, "supports_rows", False):
        return train_step(state, batch["arena"], batch["label"],
                          batch["valid"], class_weights, train_pre,
                          rows=batch["rows"], **par)
    return train_step(state, batch_pixels(batch), batch["label"],
                      batch["valid"], class_weights, train_pre, **par)


def _train_epoch_host(state, loader, class_weights, train_pre, mesh=None,
                      data_axis: str = "data"):
    """One epoch of loader batches (host batches, or streamed chunks), one
    step a batch: per-step (losses, correct, counts, live) on the host,
    fetched once. Every step is live, so the epoch loss is the mean over
    batches, as in the JAX package."""
    metrics = [_loader_step(state, b, class_weights, train_pre, mesh,
                            data_axis)
               for b in loader]
    losses, corr, counts = (
        torch.stack([m[key].reshape(()) for m in metrics]).cpu().numpy()
        if metrics else np.zeros(0)
        for key in ("loss", "correct", "count"))
    return losses, corr, counts, np.ones(len(losses), bool)


def _epoch_summary(losses, corr, counts, live) -> tuple[float, float]:
    """(average loss of the live steps, train accuracy)."""
    avg = float(losses[live].mean()) if live.any() else 0.0
    return avg, int(corr.sum()) / max(int(counts.sum()), 1)


def _eval_record(state, cfg, arena, labels, group_codes, row_ok,
                 eval_pre, loader=None, mesh=None) -> dict:
    """The fairness record over the test ``arena``, or, without one, over
    ``loader``'s batches."""
    if arena is None:
        return evaluate_fairness(state.model, None, loader, labels,
                                 group_codes, eval_pre, mesh=mesh)
    bs, k = cfg.data.batch_size, max(1, cfg.data.steps_per_dispatch)
    batches = super_batches(np.arange(arena.shape[0]), labels, bs, k,
                            drop_remainder=False, with_row_ids=True,
                            row_ok=row_ok)
    return evaluate_fairness(state.model, arena, batches, labels,
                             group_codes, eval_pre, mesh=mesh)


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
    ``out_dir`` (rank 0's, under a process group, where every rank passes
    the whole arenas)."""
    _refuse_folder_options(cfg)
    mesh, dev = _process_mesh(cfg, device)
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
    _distribute(state, mesh, cfg)
    if augment is None:
        augment = _default_augment(cfg)
    train_pre, eval_pre = _preprocess_fns(cfg, model_cfg, augment)
    class_weights = _class_weights(cfg, train_labels)

    writer = _is_writer(mesh)
    if writer:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "train_config.json"), "w") as f:
            f.write(config_lib.to_json(cfg))
    results_path = os.path.join(out_dir, f"{_timestamp()}.json")

    order_rng = np.random.default_rng(cfg.data.seed + 1)
    result = FitResult(state, [], results_path, [], [], [])
    for epoch in range(cfg.epochs):
        with annotate("epoch"):
            epoch_start = time.time()
            order = np.arange(train_arena.shape[0])
            order_rng.shuffle(order)
            losses, corr, counts, live = _train_epoch(
                state, cfg, train_arena, order, train_labels, None,
                class_weights, train_pre, mesh)
            avg_batch_loss, train_accuracy = _epoch_summary(losses, corr,
                                                            counts, live)
            epoch_time = time.time() - epoch_start
            result.step_losses.append(losses)
            result.step_correct.append(corr)
            result.step_counts.append(counts)

            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                eval_start = time.time()
                record = _eval_record(state, cfg, test_arena, test_labels,
                                      test_group_codes, None, eval_pre,
                                      mesh=mesh)
                record["avg_batch_loss"] = avg_batch_loss
                record["train_accuracy"] = train_accuracy
                record["epoch"] = epoch
                record["epoch_time_s"] = epoch_time
                record["eval_time_s"] = time.time() - eval_start
                if writer:
                    with annotate("epoch.write"):
                        jsonl.append_record(results_path, record)
                result.records.append(record)
    if mesh is not None:
        dist.barrier()
    return result


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")


def resolve_experiment_folder(cfg: TrainConfig) -> tuple[str, bool, bool]:
    """(folder, is_resume, balance). An existing ``experiment_dir``
    resumes; a new one names the mode ('imbalanced' or 'balance' in its
    base name) of a run whose folder goes under ``cfg.results_dir``
    (relative to the working directory) with a timestamp."""
    requested = cfg.experiment_dir
    if requested and os.path.exists(requested):
        return requested, True, cfg.data.balance
    if requested and "imbalanced" in os.path.basename(requested):
        balance = False
        name = f"imbalanced_{_timestamp()}"
    elif requested and "balance" in os.path.basename(requested):
        balance = True
        name = f"balanced_{_timestamp()}"
    else:
        balance = cfg.data.balance
        name = f"{'balanced' if balance else 'imbalanced'}_{_timestamp()}"
    return os.path.join(cfg.results_dir, name), False, balance


def _init_source(init_from: str) -> str:
    if os.path.isdir(init_from):
        return os.path.join(init_from, ckpt_lib.MODEL_FILENAME)
    return init_from


def _state_from_artifact(path, cfg, dev):
    """(model_cfg, state) with the weights of a ``session_model`` file and
    a fresh optimizer."""
    model_cfg, state_dict = ckpt_lib.load_model(path)
    state = create_train_state(model_cfg, cfg.optim, cfg.seed, dev)
    state.model.load_state_dict(state_dict)
    return model_cfg, state


def _check_best_metric(cfg: TrainConfig) -> None:
    """Refuse an untrackable metric before the first (costly) epoch."""
    if cfg.best_metric not in _BEST_METRICS:
        raise ValueError(f"best_metric {cfg.best_metric!r} is not trackable; "
                         f"choose one of {_BEST_METRICS}")
    if cfg.best_metric not in ("loss", "avg_batch_loss") \
            and not cfg.eval_every:
        raise ValueError(
            f"best_metric {cfg.best_metric!r} comes from the fairness eval "
            "record, which eval_every=0 disables; enable eval or track "
            "'loss'")


def run_training(cfg: TrainConfig, verbose: bool = True,
                 device="cuda") -> str:
    """Train per the config on ``device``; returns the experiment
    folder."""
    mesh, dev = _process_mesh(cfg, device)
    writer = _is_writer(mesh)
    verbose = verbose and writer
    folder, is_resume, balance = resolve_experiment_folder(cfg)
    if mesh is not None:
        # the folder's timestamp is rank 0's
        shared = [folder, is_resume, balance]
        dist.broadcast_object_list(shared, src=0)
        folder, is_resume, balance = shared
    results_path = os.path.join(folder, f"{_timestamp()}.json")
    train_csv = os.path.join(folder, TRAIN_SET_FILENAME)
    test_csv = os.path.join(folder, TEST_SET_FILENAME)
    model_path = os.path.join(folder, ckpt_lib.MODEL_FILENAME)
    ckpt_dir = os.path.join(folder, CHECKPOINT_DIRNAME)
    if cfg.checkpoint_best or cfg.early_stop_patience:
        _check_best_metric(cfg)

    # snapshot-backed epochs already in the folder; markers written by
    # this run count from there
    base_done = completed_epochs(folder) if is_resume else 0

    if is_resume:
        if verbose:
            print(f"Resuming training from {folder}")
        train_df = read_csv(train_csv, index_col=True)
        test_df = read_csv(test_csv, index_col=True)
        if os.path.exists(model_path):
            model_cfg, state = _state_from_artifact(model_path, cfg, dev)
            if os.path.exists(ckpt_dir):
                ckpt_lib.restore_train_state(ckpt_dir, state)
        else:
            # no model file: a crash before the first save (kept splits,
            # initial weights) or after a periodic snapshot. The snapshot
            # holds the architecture the run trained: cfg.model, or the
            # init_from artifact's for a fine-tune.
            if cfg.init_from:
                model_cfg, state = _state_from_artifact(
                    _init_source(cfg.init_from), cfg, dev)
            else:
                model_cfg = cfg.model
                state = create_train_state(model_cfg, cfg.optim, cfg.seed,
                                           dev)
            if os.path.exists(ckpt_dir):
                ckpt_lib.restore_train_state(ckpt_dir, state)
                if verbose:
                    print("restored the snapshot (no model artifact)")
            elif verbose:
                print("no snapshot yet; initial weights, kept splits")
    else:
        if verbose:
            print(f"New run in {folder}")
        df = read_isic_metadata(cfg.data.root_dir, seed=cfg.data.seed)
        if balance:
            df = balance_dataset(df, seed=cfg.data.seed, verbose=verbose)
        train_df, test_df = shuffle_split(
            df, ratio=cfg.data.split_ratio, seed=cfg.data.seed)
        if writer:
            # the folder is made once there is something durable in it
            os.makedirs(folder, exist_ok=True)
            train_df.to_csv(train_csv)
            test_df.to_csv(test_csv)
        if cfg.init_from:
            # fine-tune: the architecture comes from the artifact
            source = _init_source(cfg.init_from)
            model_cfg, state = _state_from_artifact(source, cfg, dev)
            if verbose:
                print(f"Fine-tuning from {source}")
        else:
            model_cfg = cfg.model
            state = create_train_state(model_cfg, cfg.optim, cfg.seed, dev)
        if writer:
            with open(os.path.join(folder, "train_config.json"), "w") as f:
                f.write(config_lib.to_json(cfg))
    _distribute(state, mesh, cfg)
    if verbose and mesh is not None:
        print(f"mesh: {dict(mesh.shape)}")

    # the flatten dense fixes the input size: an artifact trained at
    # another size wins over the data config
    if model_cfg.image_size != cfg.data.image_size:
        if verbose:
            print(f"note: model artifact expects image_size="
                  f"{model_cfg.image_size}; overriding the data config's "
                  f"{cfg.data.image_size}")
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, image_size=model_cfg.image_size))
    if verbose:
        print(f"train={len(train_df)}  test={len(test_df)}")

    train_table = LesionTable(train_df, cfg.data.root_dir)
    test_table = LesionTable(test_df, cfg.data.root_dir)
    train_arena = test_arena = train_ok = test_ok = None
    train_loader = test_loader = None
    if cfg.data.streaming:
        train_loader, test_loader = _stream_loaders(
            cfg, train_table, test_table, folder, dev, writer)
        if verbose:
            print(f"streaming ingest: chunks of {cfg.data.chunk_size}")
    else:
        stores, train_arena, test_arena = _decode_arenas(
            cfg, train_table, test_table, dev, verbose)
        train_ok, test_ok = stores[0].row_ok, stores[1].row_ok
        # the splits without an arena on the card take host batches
        if train_arena is None:
            train_loader = BatchIterator(
                stores[0], cfg.data.batch_size, device=dev, shuffle=True,
                drop_remainder=cfg.data.drop_remainder,
                seed=cfg.data.seed + 1, prefetch=cfg.data.prefetch_depth)
        if test_arena is None:
            test_loader = BatchIterator(
                stores[1], cfg.data.batch_size, device=dev, shuffle=False,
                drop_remainder=False, seed=0,
                prefetch=cfg.data.prefetch_depth)

    train_pre, eval_pre = _preprocess_fns(cfg, model_cfg,
                                          _default_augment(cfg))
    class_weights = _class_weights(cfg, train_table.labels)
    if verbose and cfg.optim.auto_class_weights:
        print(f"class weights (balanced): {class_weights}")

    start = time.time()
    # best value so far, seeded from the folder's earlier records so that
    # a worse epoch after a resume never replaces a better best model
    best_value = _prior_best(folder, cfg.best_metric) if (
        cfg.checkpoint_best or cfg.early_stop_patience) else None
    epochs_since_best = 0
    epochs_run = 0
    order_rng = np.random.default_rng(cfg.data.seed + 1)
    for epoch in range(cfg.epochs):
        with annotate("epoch"):
            epoch_start = time.time()
            record = None
            if verbose:
                print(f"Epoch {epoch + 1}/{cfg.epochs}")
                print("-" * 10)
            decoded0 = _stream_counts(train_loader, test_loader)
            if train_loader is not None:
                losses, corr, counts, live = _train_epoch_host(
                    state, train_loader, class_weights, train_pre, mesh,
                    cfg.mesh.data_axis)
            else:
                order = np.arange(len(train_table))
                order_rng.shuffle(order)
                losses, corr, counts, live = _train_epoch(
                    state, cfg, train_arena, order, train_table.labels,
                    train_ok, class_weights, train_pre, mesh)
            avg_batch_loss, train_accuracy = _epoch_summary(losses, corr,
                                                            counts, live)
            epoch_time = time.time() - epoch_start
            with annotate("epoch.write"):
                if verbose:
                    print(f"Train Loss: {avg_batch_loss:.4f} "
                          f"Train Acc: {train_accuracy:.4f}")
                    print(f"Epoch time: {epoch_time:.2f}s\n")
                if (cfg.checkpoint_every
                        and (epoch + 1) % cfg.checkpoint_every == 0):
                    # the marker follows the snapshot it counts
                    _save_state(ckpt_dir, state, mesh)
                    if writer:
                        _mark_progress(folder, base_done + epoch + 1)

            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                eval_start = time.time()
                record = _eval_record(state, cfg, test_arena,
                                      test_table.labels,
                                      test_table.group_codes, test_ok,
                                      eval_pre, test_loader, mesh)
                record["avg_batch_loss"] = avg_batch_loss
                record["train_accuracy"] = train_accuracy
                record["epoch"] = epoch
                record["epoch_time_s"] = epoch_time
                record["eval_time_s"] = time.time() - eval_start
                if writer:
                    with annotate("epoch.write"):
                        jsonl.append_record(results_path, record)
            if verbose and cfg.data.streaming:
                frames, cached, secs = (
                    b - a for a, b in zip(decoded0, _stream_counts(
                        train_loader, test_loader)))
                print(f"stream: decoded {frames} frames in {secs:.2f}s, "
                      f"{cached} from the cache")
            if mesh is not None and cfg.data.stream_cache:
                # the writer's cache is complete before any rank's next epoch
                dist.barrier()

            # keep-best and early stop: 'loss' every epoch (lower is better),
            # a record key on eval epochs only (higher is better); other
            # epochs neither improve nor use up patience
            if cfg.best_metric in ("loss", "avg_batch_loss"):
                current, higher_better = avg_batch_loss, False
            elif (record is not None
                  and record.get(cfg.best_metric) is not None):
                current, higher_better = float(record[cfg.best_metric]), True
            else:
                current = None
            epochs_run = epoch + 1
            if current is not None:
                improved = best_value is None or (
                    current > best_value if higher_better
                    else current < best_value)
                if improved:
                    best_value = current
                    epochs_since_best = 0
                    if cfg.checkpoint_best:
                        with annotate("epoch.write"):
                            _save_model(
                                os.path.join(folder,
                                             ckpt_lib.BEST_MODEL_FILENAME),
                                model_cfg, state, mesh)
                else:
                    epochs_since_best += 1
                if (cfg.early_stop_patience
                        and epochs_since_best >= cfg.early_stop_patience):
                    if verbose:
                        print(f"early stop: {cfg.best_metric} has not "
                              f"improved for {epochs_since_best} epochs "
                              f"(best {best_value:.4f})")
                    break

            # fault injection: when the env names an existing file, remove it
            # and fail once (how run_training_elastic is tested end to end)
            fault = os.environ.get("SIA_FAULT_ONCE")
            if fault and os.path.exists(fault):
                os.remove(fault)
                raise RuntimeError(
                    f"injected fault after epoch {epoch} (SIA_FAULT_ONCE)")

    elapsed = time.time() - start
    if verbose:
        print(f"Training complete in {elapsed // 60:.0f}m "
              f"{elapsed % 60:.0f}s")
    _save_model(model_path, model_cfg, state, mesh)
    _save_state(ckpt_dir, state, mesh)
    if writer:
        # the epochs actually trained (fewer when early stop fired)
        _mark_progress(folder, base_done + epochs_run)
    if mesh is not None:
        dist.barrier()
    return folder


def _stream_loaders(cfg: TrainConfig, train_table: LesionTable,
                    test_table: LesionTable, folder: str,
                    dev: torch.device, writer: bool):
    """The streamed (train, test) loaders, with the JAX package's seeds;
    with ``stream_cache`` their frames are cached in the folder: the
    writer (rank 0) fills the cache in the first epoch, and the other
    ranks of a mesh decode that epoch too and read the cache from the
    next epoch on (the run's barrier after each epoch orders them)."""
    s = cfg.data.canonical_size
    cached = cfg.data.stream_cache

    def loader(table, split, shuffle, drop_remainder, seed):
        return ChunkedBatchIterator(
            table, canonical_size=s, batch_size=cfg.data.batch_size,
            chunk_size=cfg.data.chunk_size, shuffle=shuffle,
            drop_remainder=drop_remainder, seed=seed, device=dev,
            cache_path=cache_file(folder, split, s) if cached else None,
            workers=cfg.data.decode_workers, cache_reader=not writer)

    return (loader(train_table, "train", True, cfg.data.drop_remainder,
                   cfg.data.seed + 1),
            loader(test_table, "test", False, False, 0))


def _stream_counts(*loaders) -> tuple[int, int, float]:
    """(frames decoded, frames read from the cache, decode seconds) of the
    streamed loaders so far."""
    streamed = [ld for ld in loaders if isinstance(ld, ChunkedBatchIterator)]
    return (sum(ld.frames_decoded for ld in streamed),
            sum(ld.frames_cached for ld in streamed),
            sum(ld.decode_seconds for ld in streamed))


def _decode_arenas(cfg: TrainConfig, train_table: LesionTable,
                   test_table: LesionTable, dev: torch.device,
                   verbose: bool):
    """Decode both splits; put their arenas on ``dev`` when
    ``device_cache`` is on and both fit ``device_cache_max_bytes``:
    ((train store, test store), train arena, test arena). An arena not on
    the card is None: that split takes host batches, also when its upload
    runs out of device memory."""
    s = cfg.data.canonical_size
    t0 = time.time()
    stores = [HostImageStore(table, s, cfg.data.decode_workers)
              for table in (train_table, test_table)]
    if verbose:
        print(f"decoded {len(train_table) + len(test_table)} images in "
              f"{time.time() - t0:.1f}s")
    total = sum(store.images.nbytes for store in stores)
    if not cfg.data.device_cache \
            or total > cfg.data.device_cache_max_bytes:
        if verbose:
            print(f"host-batch feed: {total / 1e6:.0f} MB of images stay "
                  "on the host")
        return stores, None, None

    def arena(split, store):
        try:
            return store.to_device(dev)
        except torch.cuda.OutOfMemoryError:
            if verbose:
                print(f"the '{split}' arena does not fit in free device "
                      "memory: host batches for this split", flush=True)
            return None

    arenas = [arena(split, store)
              for split, store in zip(("train", "test"), stores)]
    return stores, arenas[0], arenas[1]


def _prior_best(folder: str, metric: str):
    """Best ``metric`` value across the folder's epoch records (every
    timestamped JSON-lines file); None when there is none. 'loss' reads
    avg_batch_loss (lower is better)."""
    lower_better = metric in ("loss", "avg_batch_loss")
    key = "avg_batch_loss" if lower_better else metric
    values: list[float] = []
    for p in glob.glob(os.path.join(folder, "*.json")):
        if not os.path.basename(p)[0].isdigit():
            continue
        values += [float(rec[key]) for rec in jsonl.read_records(p)
                   if key in rec]
    if not values:
        return None
    return min(values) if lower_better else max(values)


def _mark_progress(folder: str, total_epochs_done: int) -> None:
    """Append a progress marker: the snapshot-backed epochs in the folder
    as of the save that just completed."""
    with open(os.path.join(folder, PROGRESS_FILENAME), "a") as f:
        f.write(f"{int(total_epochs_done)}\n")


def completed_epochs(folder: str) -> int:
    """Snapshot-backed completed epochs of an experiment folder: the last
    progress marker; for a folder without markers, the count of epoch
    records where a model file exists, else 0."""
    progress = os.path.join(folder, PROGRESS_FILENAME)
    if os.path.exists(progress):
        last = 0
        with open(progress) as f:
            for line in f:
                if line.strip():
                    last = int(line)
        return last
    if not os.path.exists(os.path.join(folder, ckpt_lib.MODEL_FILENAME)):
        return 0
    n = 0
    for p in glob.glob(os.path.join(folder, "*.json")):
        if os.path.basename(p)[0].isdigit():
            with open(p) as f:
                n += sum(1 for line in f if line.strip())
    return n


def run_training_elastic(cfg: TrainConfig, retries: int = 0,
                         verbose: bool = True, device="cuda") -> str:
    """:func:`run_training` with crash recovery, up to ``retries``
    restarts.

    ``cfg.epochs`` are epochs added to whatever the folder holds, as in
    a plain run. After an exception the supervisor finds the folder (the
    one it was resuming, or the newest folder of this mode made since it
    started, with both split CSVs) and resumes it for the epochs not yet
    backed by a snapshot since this call began; a half-made folder
    without both split CSVs is abandoned for a fresh run. Pair with
    ``checkpoint_every=1`` for recovery an epoch at a time."""
    supervisor_start = time.time()
    target = cfg.experiment_dir
    # the mode prefix as run_training infers it (a new experiment_dir's
    # name overrides cfg.data.balance)
    _, _, balance = resolve_experiment_folder(cfg)
    prefix = "balanced" if balance else "imbalanced"
    expected_total = cfg.epochs + (
        completed_epochs(target) if target and os.path.isdir(target) else 0)
    failures = 0
    while True:
        run_cfg = cfg
        if failures and target and os.path.isdir(target):
            remaining = expected_total - completed_epochs(target)
            if remaining <= 0:
                if verbose:
                    print("auto-resume: training already complete")
                return target
            run_cfg = dataclasses.replace(cfg, epochs=remaining,
                                          experiment_dir=target)
        try:
            return run_training(run_cfg, verbose=verbose, device=device)
        except KeyboardInterrupt:
            raise
        except Exception as e:
            failures += 1
            if failures > retries:
                raise

            def has_splits(d):
                return all(os.path.exists(os.path.join(d, f))
                           for f in (TRAIN_SET_FILENAME, TEST_SET_FILENAME))

            if target and os.path.isdir(target) and not has_splits(target):
                # a half-made folder can never resume: run fresh
                target = None
                if cfg.experiment_dir:
                    cfg = dataclasses.replace(cfg, experiment_dir=None)
            if not (target and os.path.isdir(target)):
                # a fresh run died: the folder it made, if any
                cands = [
                    d for d in glob.glob(
                        os.path.join(cfg.results_dir, f"{prefix}_*"))
                    if os.path.isdir(d)
                    and os.path.getmtime(d) >= supervisor_start - 1
                    and has_splits(d)
                ]
                if cands:
                    target = max(cands, key=os.path.getmtime)
            if verbose:
                print(f"auto-resume: restart {failures}/{retries} after "
                      f"{type(e).__name__}: {e} -> "
                      f"{target or 'fresh run'}")

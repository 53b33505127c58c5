"""The transfer trainer over LesionTables (port of the JAX package's
``train.classify``).

One trainer drives the side tasks: the tone classifier's light/dark
ResNet transfer and the HAM-10000 2- and 7-class ``dx`` experiments, with
any ``class_names`` / ``label_column`` of a ``LesionTable``. It trains
with class-weighted NLL, an oversampler drawing with replacement, and
crop + flip + ImageNet-normalize augmentation through the fused
preprocess kernel (``make_preprocess_fn(layout="planar")``: on a card
tensor the kernel, on a CPU tensor its plain twin), evaluates every epoch
(accuracy and macro precision, recall and F1; AUC for 2 classes;
optionally five-crop test-time augmentation), keeps the best epoch and
stops early, logs wandb-style to ``metrics.jsonl``, and writes
``session_model.msgpack`` (the JAX package's format), the two split CSVs
and ``train_config.json``. With ``input_mode="ita"`` the model takes the
two ITA channels (``data.ita``: ITA/90 of the skin pixels and the skin
mask) of the cropped and flipped [0, 1] RGB, in place of the ImageNet
normalization, and has two input channels.

Both splits are decoded once into planar uint8 arenas on ``device``; the
epochs run ``steps_per_dispatch`` steps a call from them. Decoding is
inline, so a decode error raises where it happens.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig
from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.ita import (
    ita_input,
    ita_input_planar,
)
from skin_image_analysis_tpu_torch.data.loader import (
    BatchIterator,
    HostImageStore,
)
from skin_image_analysis_tpu_torch.metrics.auc import roc_auc
from skin_image_analysis_tpu_torch.ops.preprocess import (
    AugmentConfig,
    make_preprocess_fn,
    normalize_affine,
)
from skin_image_analysis_tpu_torch.toneclassifier.class_weight import (
    balanced_class_weights,
)
from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib
from skin_image_analysis_tpu_torch.train.loop import (
    TEST_SET_FILENAME,
    TRAIN_SET_FILENAME,
    resolve_device,
    super_batches,
)
from skin_image_analysis_tpu_torch.train.state import create_train_state
from skin_image_analysis_tpu_torch.train.step import (
    make_five_crop_eval_step,
    multi_eval_step,
    multi_train_step,
)
from skin_image_analysis_tpu_torch.utils.metrics_log import (
    MetricsLogger,
    binary_metrics,
)
from skin_image_analysis_tpu_torch.utils.profiling import annotate


@dataclass(frozen=True)
class ClassifyConfig:
    model_name: str = "resnet50"
    num_classes: int = 2
    image_size: int = 224
    canonical_size: int = 256
    batch_size: int = 32
    epochs: int = 10
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    optimizer: str = "adamw"
    use_class_weights: bool = True
    oversample: bool = False
    augment: bool = True
    normalize_imagenet: bool = True
    input_affine: tuple | None = None  # (scale, offset) on the [0, 1]
                                    # floats; exclusive with
                                    # normalize_imagenet
    seed: int = 0
    compute_dtype: str = "bfloat16"
    out_dir: str = "classify_runs"
    freeze_backbone: bool = False   # train the head only
    input_mode: str = "rgb"         # "ita": the ITA channels (data.ita)
    five_crop_eval: bool = False    # five-crop test-time augmentation;
                                    # needs canonical_size > image_size
    steps_per_dispatch: int = 1     # train steps / eval batches a call
    checkpoint_best: bool = False   # keep session_model_best.msgpack
    best_metric: str = "accuracy"   # an epoch-metric key ('accuracy',
                                    # 'auc', 'f1': higher is better) or
                                    # 'loss' (train_loss_mean, lower)
    early_stop_patience: int = 0    # stop after N epochs without a
                                    # best_metric improvement (0 = off)


def multiclass_metrics(preds, labels, n_classes: int) -> dict[str, float]:
    """Accuracy and macro-averaged precision, recall and F1; for two
    classes the binary report with class 1 positive. The span
    ``audit.record`` marks it."""
    with annotate("audit.record"):
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        if n_classes == 2:
            return binary_metrics(preds, labels)
        accuracy = float((preds == labels).mean()) if preds.size else 0.0
        ps, rs, fs = [], [], []
        for c in range(n_classes):
            tp = int(((preds == c) & (labels == c)).sum())
            fp = int(((preds == c) & (labels != c)).sum())
            fn = int(((preds != c) & (labels == c)).sum())
            p = tp / (tp + fp) if tp + fp else 0.0
            r = tp / (tp + fn) if tp + fn else 0.0
            f = 2 * p * r / (p + r) if p + r else 0.0
            ps.append(p), rs.append(r), fs.append(f)
        return {
            "accuracy": accuracy,
            "precision": float(np.mean(ps)),
            "recall": float(np.mean(rs)),
            "f1": float(np.mean(fs)),
        }


def _oversampled_order(labels: np.ndarray,
                       rng: np.random.Generator) -> np.ndarray:
    """An epoch of ``len(labels)`` rows drawn with replacement, each row
    weighted by its class's balanced weight."""
    weights = balanced_class_weights(labels, int(labels.max()) + 1)[labels]
    p = weights / weights.sum()
    return rng.choice(len(labels), size=len(labels), replace=True, p=p)


def _validate(cfg: ClassifyConfig) -> None:
    """Refuse a config before any decode or init work."""
    if cfg.input_mode not in ("rgb", "ita"):
        raise ValueError(f"input_mode must be rgb|ita, got {cfg.input_mode!r}")
    if cfg.five_crop_eval and cfg.canonical_size <= cfg.image_size:
        raise ValueError(
            "five_crop_eval needs canonical_size > image_size "
            f"({cfg.canonical_size} <= {cfg.image_size})"
        )
    if cfg.checkpoint_best or cfg.early_stop_patience:
        trackable = ("loss", "train_loss_mean", "accuracy",
                     "precision", "recall", "f1") + (
                         ("auc",) if cfg.num_classes == 2 else ())
        if cfg.best_metric not in trackable:
            raise ValueError(
                f"best_metric {cfg.best_metric!r} is not trackable; "
                f"choose one of {trackable}"
                + ("" if cfg.num_classes == 2
                   else " ('auc' needs num_classes == 2)"))


def _ita_wrap(pre):
    """``pre`` (planar uint8 -> NHWC [0, 1] RGB, the view of a planar
    tensor) followed by the ITA channels, computed planar."""
    def fn(pixels, generator=None, **kw):
        x = pre(pixels, generator, **kw).permute(0, 3, 1, 2)
        return ita_input_planar(x).permute(0, 2, 3, 1)

    fn.supports_rows = getattr(pre, "supports_rows", False)
    return fn


def _train_epoch(state, arena, order, labels, row_ok, batch_size: int,
                 k: int, class_weights, train_pre) -> list[float]:
    """One epoch, ``k`` steps a call; the losses of its live steps. One
    step a call (``k == 1``) runs every batch, as the JAX package's
    per-batch path does; with ``k > 1`` the all-invalid steps are inert."""
    metrics = [
        multi_train_step(state, arena, ib, lb, vd, class_weights, train_pre,
                         skip_empty=k > 1)
        for ib, lb, vd in super_batches(order, labels, batch_size, k,
                                        drop_remainder=True, row_ok=row_ok)
    ]
    if not metrics:  # a train split smaller than one batch
        return []
    losses = torch.cat([m["loss"] for m in metrics]).cpu().numpy()
    if k > 1:
        losses = losses[torch.cat([m["count"] for m in metrics])
                        .cpu().numpy() > 0]
    return [float(v) for v in losses]


def _evaluate(state, arena, table: LesionTable, row_ok, batch_size: int,
              k: int, eval_pre, five_crop) -> tuple[np.ndarray, ...]:
    """(preds, labels, log_probs) of the valid test rows."""
    dev = arena.device
    preds, log_probs, keep = [], [], []
    for ib, rid, vd in super_batches(np.arange(len(table)), table.labels,
                                     batch_size, 1 if five_crop else k,
                                     drop_remainder=False, with_row_ids=True,
                                     row_ok=row_ok):
        if five_crop is not None:
            rows = torch.from_numpy(ib[0].astype(np.int64)).to(dev)
            out = five_crop(state.model, arena[rows].permute(0, 2, 3, 1),
                            None)
            preds.append(out["pred"][None])
            log_probs.append(out["log_probs"][None])
        else:
            out = multi_eval_step(state.model, arena, ib, rid, vd, eval_pre)
            preds.append(out["pred"])
            log_probs.append(out["log_probs"])
        keep.append((ib, vd))
    with annotate("audit.fetch"):
        pred = torch.cat(preds).reshape(-1).cpu().numpy()
        lp = torch.cat(log_probs).flatten(0, 1).cpu().numpy()
    valid = np.concatenate([v.reshape(-1) for _, v in keep])
    idx = np.concatenate([i.reshape(-1) for i, _ in keep])
    return pred[valid], table.labels[idx][valid], lp[valid]


def train_classifier(
    train_table: LesionTable,
    test_table: LesionTable,
    cfg: ClassifyConfig = ClassifyConfig(),
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Train per ``cfg`` on ``device``; returns ``{state, history,
    test_metrics, out_dir, model_path}``."""
    _validate(cfg)
    dev = resolve_device(device)
    class_weights = (
        tuple(balanced_class_weights(train_table.labels, cfg.num_classes))
        if cfg.use_class_weights
        else None
    )
    model_cfg = ModelConfig(
        name=cfg.model_name, num_classes=cfg.num_classes,
        image_size=cfg.image_size, compute_dtype=cfg.compute_dtype,
        freeze_backbone=cfg.freeze_backbone,
        in_channels=2 if cfg.input_mode == "ita" else 3,
    )
    optim_cfg = OptimConfig(
        optimizer=cfg.optimizer, learning_rate=cfg.learning_rate,
        weight_decay=cfg.weight_decay,
    )
    state = create_train_state(model_cfg, optim_cfg, cfg.seed, device=dev)

    ita_mode = cfg.input_mode == "ita"
    # ITA takes the raw sRGB in [0, 1]; its channels replace the
    # normalization
    norm = cfg.normalize_imagenet and not ita_mode
    affine = cfg.input_affine if not ita_mode else None
    train_pre = make_preprocess_fn(
        cfg.image_size, train=True,
        augment=AugmentConfig(random_crop=True, horizontal_flip=True)
        if cfg.augment else None,
        normalize_imagenet=norm, input_affine=affine, layout="planar",
    )
    eval_pre = make_preprocess_fn(
        cfg.image_size, train=False, normalize_imagenet=norm,
        input_affine=affine, layout="planar",
    )
    if ita_mode:
        train_pre, eval_pre = _ita_wrap(train_pre), _ita_wrap(eval_pre)
    five_crop = (make_five_crop_eval_step(
        cfg.image_size, normalize_imagenet=norm,
        channels_fn=ita_input if ita_mode else None, input_affine=affine)
        if cfg.five_crop_eval else None)
    k = max(1, cfg.steps_per_dispatch)

    train_store = HostImageStore(train_table, cfg.canonical_size)
    test_store = HostImageStore(test_table, cfg.canonical_size)
    train_arena = train_store.to_device(dev)
    test_arena = test_store.to_device(dev)
    order_fn = (
        (lambda rng: _oversampled_order(train_table.labels, rng))
        if cfg.oversample
        else None
    )
    train_loader = BatchIterator(
        train_store, cfg.batch_size, device=dev, shuffle=True,
        drop_remainder=True, seed=cfg.seed + 1, order_fn=order_fn,
    )

    history = []
    best_value = None
    best_snapshot = None   # the best epoch's state_dict, on the host
    epochs_since_best = 0
    with MetricsLogger(cfg.out_dir,
                       run_name=f"classify_{cfg.model_name}") as logger:
        step_idx = 0
        for epoch in range(cfg.epochs):
            with annotate("epoch"):
                losses = _train_epoch(
                    state, train_arena, train_loader.epoch_order(),
                    train_table.labels, train_store.row_ok, cfg.batch_size, k,
                    class_weights, train_pre)
                step_idx += len(losses)
                preds, labels, log_probs = _evaluate(
                    state, test_arena, test_table, test_store.row_ok,
                    cfg.batch_size, k, eval_pre, five_crop)
                m = multiclass_metrics(preds, labels, cfg.num_classes)
                if cfg.num_classes == 2 and labels.size:
                    m["auc"] = roc_auc(labels, np.exp(log_probs[:, 1]))
                m["epoch"] = epoch
                m["train_loss_mean"] = (float(np.mean(losses)) if losses
                                        else 0.0)
                with annotate("epoch.write"):
                    for i, loss in enumerate(losses):
                        logger.log({"train_loss": loss},
                                   step=step_idx - len(losses) + i)
                    logger.log(m, step=step_idx)
                    history.append(m)
                    if verbose:
                        print(f"epoch {epoch}: {m}")

                if (cfg.checkpoint_best or cfg.early_stop_patience) and (
                    cfg.best_metric != "auc" or "auc" in m
                ):  # auc is absent on an empty test split: skip the epoch
                    lower = cfg.best_metric in ("loss", "train_loss_mean")
                    key = "train_loss_mean" if lower else cfg.best_metric
                    val = float(m[key])
                    if best_value is None or (
                        val < best_value if lower else val > best_value
                    ):
                        best_value = val
                        epochs_since_best = 0
                        if cfg.checkpoint_best:
                            with annotate("epoch.write"):
                                best_snapshot = {
                                    n: t.detach().to("cpu", copy=True)
                                    for n, t in
                                    state.model.state_dict().items()}
                    else:
                        epochs_since_best += 1
                    if (cfg.early_stop_patience
                            and epochs_since_best
                            >= cfg.early_stop_patience):
                        if verbose:
                            print(f"early stop: {cfg.best_metric} has not "
                                  f"improved for {epochs_since_best} epochs "
                                  f"(best {best_value:.4f})")
                        break

    # the folder of a tone_bias_train experiment: the model artifact, the
    # frozen splits and the input convention
    model_path = os.path.join(cfg.out_dir, ckpt_lib.MODEL_FILENAME)
    ckpt_lib.save_model(model_path, model_cfg, state.model.state_dict())
    if best_snapshot is not None:
        ckpt_lib.save_model(
            os.path.join(cfg.out_dir, ckpt_lib.BEST_MODEL_FILENAME),
            model_cfg, best_snapshot)
    train_table.metadata.to_csv(os.path.join(cfg.out_dir, TRAIN_SET_FILENAME))
    test_table.metadata.to_csv(os.path.join(cfg.out_dir, TEST_SET_FILENAME))
    with open(os.path.join(cfg.out_dir, "train_config.json"), "w") as f:
        data_cfg = {"normalize_imagenet": norm}
        if affine is not None:
            data_cfg["input_affine"] = [list(v) for v in
                                        normalize_affine(affine)]
        json.dump({"data": data_cfg,
                   "class_names": list(train_table.class_names),
                   "classify": cfg.__dict__}, f, indent=2, default=str)

    return {
        "state": state,
        "history": history,
        "test_metrics": history[-1] if history else {},
        "out_dir": cfg.out_dir,
        "model_path": model_path,
    }

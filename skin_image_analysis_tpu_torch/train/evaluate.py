"""Evaluation: predictions over the test split, the per-epoch fairness
record, and the reference's prediction and accuracy helpers (port of the
JAX package's ``train.evaluate``).

The batches are super-batches of a device arena, or the host batches of a
``BatchIterator`` (or the chunk rows of a streaming iterator). The record is the reference ``analyse_predictions``
schema, reduced on the device from integer confusion counts, plus
``auc``, the per-tone accuracies and gap, and ``auc_dark``/``auc_light``.
Labels and group codes come as arrays indexed by row id.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.metrics.auc import roc_auc
from skin_image_analysis_tpu_torch.metrics.device import (
    analyse_predictions_device,
)
from skin_image_analysis_tpu_torch.train.step import (
    eval_step,
    multi_eval_step,
)
from skin_image_analysis_tpu_torch.utils.profiling import annotate


def batch_pixels(batch: dict) -> torch.Tensor:
    """A loader batch's pixels: ``"pixels"``, or the rows ``"rows"`` of a
    streamed chunk ``"arena"`` (``data.streaming``)."""
    if "pixels" in batch:
        return batch["pixels"]
    return batch["arena"][batch["rows"].long()]


def _batch_outputs(model, arena, batches, preprocess_fn, mesh=None):
    """The eval outputs of each call: ``multi_eval_step`` over the
    super-batches of the device ``arena``, or, with ``arena=None``,
    ``eval_step`` over a loader's batches."""
    if arena is not None:
        return [multi_eval_step(model, arena, ib, rid, vd, preprocess_fn,
                                mesh=mesh)
                for ib, rid, vd in batches]
    return [eval_step(model, batch_pixels(b), b["row_id"], b["valid"],
                      preprocess_fn, mesh=mesh) for b in batches]


def collect_predictions(
    model: torch.nn.Module,
    arena: torch.Tensor | None,
    batches: Iterable,
    preprocess_fn: Callable | None = None,
    mesh=None,
) -> dict[str, np.ndarray]:
    """Run the model over ``batches``: ``(idx, row_id, valid)`` ``[k, B]``
    super-batches of the device ``arena``, or, with ``arena=None``, a
    :class:`~skin_image_analysis_tpu_torch.data.loader.BatchIterator` of
    host batches (or a ``data.streaming.ChunkedBatchIterator`` of chunk
    rows). Returns ``{"pred", "row_id", "score_malignant"}`` over the
    valid rows, fetched to the host in one go. Under a process ``mesh``
    each rank scores its rows of every batch and every rank returns the
    whole split's predictions."""
    outs = _batch_outputs(model, arena, batches, preprocess_fn, mesh)
    preds, row_ids, scores = [], [], []
    with annotate("audit.fetch"):
        for out in outs:
            valid = out["valid"].reshape(-1).cpu().numpy()
            preds.append(out["pred"].reshape(-1).cpu().numpy()[valid])
            row_ids.append(out["row_id"].reshape(-1).cpu().numpy()[valid])
            lp = out["log_probs"].reshape(-1, out["log_probs"].shape[-1])
            scores.append(np.exp(lp.cpu().numpy()[valid][:, 1]))
    return {
        "pred": np.concatenate(preds),
        "row_id": np.concatenate(row_ids),
        "score_malignant": np.concatenate(scores),
    }


def predict_with_instance(
    model: torch.nn.Module,
    loader: Iterable[dict],
    table: LesionTable,
    preprocess_fn: Callable | None = None,
) -> dict[int, dict]:
    """The reference API: row-id-keyed instance dicts with the predicted
    class name under ``'prediction'``."""
    out = collect_predictions(model, None, loader, preprocess_fn)
    instances: dict[int, dict] = {}
    for pred, row_id in zip(out["pred"], out["row_id"]):
        inst = table.instance(int(row_id))
        inst["prediction"] = table.class_names[int(pred)]
        instances[int(row_id)] = inst
    return instances


def fairness_record(
    preds: np.ndarray,
    row_ids: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    group_codes: Mapping[str, np.ndarray],
    device="cuda",
) -> dict:
    """The per-epoch record from per-row predictions, malignant scores and
    arena row ids; ``labels`` and each ``group_codes[attr]`` are indexed by
    arena row. The confusion counts reduce on ``device``. The span
    ``audit.record`` marks it, as ``audit.fetch`` marks the fetch of
    :func:`collect_predictions`."""
    with annotate("audit.record"):
        order = np.argsort(row_ids)
        preds = np.asarray(preds)[order].astype(np.int32)
        row_ids = np.asarray(row_ids)[order]
        scores = np.asarray(scores)[order]
        labels = np.asarray(labels)[row_ids]

        def dev(a):
            return torch.as_tensor(np.asarray(a), device=device)

        groups = {attr: dev(np.asarray(codes)[row_ids])
                  for attr, codes in group_codes.items()}
        record = analyse_predictions_device(
            dev(preds), dev(labels), groups,
            torch.ones(len(preds), dtype=torch.bool, device=device),
        )
        record["auc"] = roc_auc(labels, scores)

        tone = record["tone_di_results"]
        min_count, maj_count = tone["min_count"], tone["maj_count"]
        acc_dark = (
            (tone["tp_min"] + tone["tn_min"]) / min_count if min_count else 0.0
        )
        acc_light = (
            (tone["tp_maj"] + tone["tn_maj"]) / maj_count if maj_count else 0.0
        )
        record["tone_accuracy_dark"] = acc_dark
        record["tone_accuracy_light"] = acc_light
        record["tone_accuracy_gap"] = acc_dark - acc_light
        if "skin_tone" in group_codes:
            codes = np.asarray(group_codes["skin_tone"])[row_ids]
            dark, light = codes == 1, codes == 0
            record["auc_dark"] = roc_auc(labels[dark], scores[dark])
            record["auc_light"] = roc_auc(labels[light], scores[light])
        return record


def evaluate_fairness(
    model: torch.nn.Module,
    arena: torch.Tensor | None,
    batches: Iterable,
    labels: np.ndarray,
    group_codes: Mapping[str, np.ndarray],
    preprocess_fn: Callable | None = None,
    mesh=None,
) -> dict:
    """The full per-epoch fairness record over the test split's
    ``batches`` (as :func:`collect_predictions` takes them); under a
    process ``mesh`` each rank scores its shard and every rank computes
    the single-process record."""
    out = collect_predictions(model, arena, batches, preprocess_fn, mesh)
    device = arena.device if arena is not None else batches.device
    return fairness_record(out["pred"], out["row_id"],
                           out["score_malignant"], labels, group_codes,
                           device=device)


def _labelled_outputs(model, loader, preprocess_fn):
    """(labels, preds) of the valid rows of each host batch."""
    for batch in loader:
        out = eval_step(model, batch["pixels"], batch["row_id"],
                        batch["valid"], preprocess_fn)
        valid = batch["valid"].cpu().numpy()
        yield (batch["label"].cpu().numpy()[valid],
               out["pred"].cpu().numpy()[valid])


def evaluate_model(model: torch.nn.Module, loader: Iterable[dict],
                   preprocess_fn: Callable | None = None) -> float:
    """Whole-set accuracy over a :class:`BatchIterator`'s batches."""
    correct = total = 0
    for labels, preds in _labelled_outputs(model, loader, preprocess_fn):
        correct += int((preds == labels).sum())
        total += len(labels)
    return correct / max(total, 1)


def evaluate_model_by_class(
    model: torch.nn.Module, loader: Iterable[dict], n_classes: int = 2,
    preprocess_fn: Callable | None = None,
) -> dict[int, float]:
    """Per-class accuracy over a :class:`BatchIterator`'s batches."""
    correct = np.zeros(n_classes)
    total = np.zeros(n_classes)
    for labels, preds in _labelled_outputs(model, loader, preprocess_fn):
        for c in range(n_classes):
            mask = labels == c
            total[c] += mask.sum()
            correct[c] += (preds[mask] == c).sum()
    return {c: correct[c] / max(total[c], 1) for c in range(n_classes)}

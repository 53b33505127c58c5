"""ROC AUC: the Mann-Whitney U statistic with midrank ties, on the host
and on the device (port of the JAX package's ``metrics.auc``)."""

from __future__ import annotations

import numpy as np
import torch


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """``labels`` in {0, 1} (1 = malignant), ``scores`` any monotone score
    of the positive class. NaN when a class is absent."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(scores.size, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < scores.size:
        j = i
        while j + 1 < scores.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[labels == 1].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def roc_auc_device(labels: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`roc_auc` on the tensors' device, in float32, over a
    fixed-size (optionally padded) batch: midranks from one sort, tie
    groups from the sorted scores' boundaries. Rows where ``valid`` is
    False rank below every other row and count in neither class. A 0-d
    tensor, NaN when a class is absent."""
    labels = labels.float()
    if valid is not None:
        valid = valid.bool()
        labels = labels * valid.float()
        pos_mask = (labels > 0) & valid
        neg_mask = (labels == 0) & valid
        scores = torch.where(valid, scores,
                             torch.full_like(scores, float("-inf")))
    else:
        pos_mask = labels > 0
        neg_mask = labels == 0

    n = scores.shape[0]
    dev = scores.device
    order = torch.argsort(scores, stable=True)
    sorted_scores = scores[order]
    idx = torch.arange(n, device=dev)
    new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           sorted_scores[1:] != sorted_scores[:-1]])
    group_id = torch.cumsum(new_group.long(), 0) - 1
    first = torch.zeros(n, dtype=torch.long, device=dev).scatter_reduce(
        0, group_id, idx, "amin", include_self=False)[group_id]
    last = torch.zeros(n, dtype=torch.long, device=dev).scatter_reduce(
        0, group_id, idx, "amax", include_self=False)[group_id]
    midranks_sorted = 0.5 * (first + last).float() + 1.0
    ranks = torch.zeros(n, dtype=torch.float32, device=dev).scatter(
        0, order, midranks_sorted)

    n_pos = pos_mask.float().sum()
    n_neg = neg_mask.float().sum()
    rank_sum_pos = torch.where(pos_mask, ranks, 0.0).sum()
    if valid is not None:
        # the invalid rows rank below every valid row, lifting each
        # positive's rank by their count
        n_invalid = n - valid.float().sum()
        rank_sum_pos = rank_sum_pos - n_pos * n_invalid
    u = rank_sum_pos - n_pos * (n_pos + 1.0) / 2.0
    denom = n_pos * n_neg
    return torch.where(denom > 0, u / denom,
                       torch.tensor(float("nan"), device=dev))

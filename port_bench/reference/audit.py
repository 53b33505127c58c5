"""The audit records, plainly.

The flagship's per-epoch fairness record (the reference repository's
``analyse_predictions`` schema): over the test rows, overall correct,
total and accuracy; the group sizes; and for each audited attribute
(skin tone dark vs light, sex female vs male, the placebo control poor vs
rich) the disparate-impact dict from the two groups' confusion counts,
positive = malignant (label 1); plus the ROC AUC of the malignant score
overall and per tone, and the per-tone accuracies. The transfer models'
record: accuracy and the macro-averaged precision, recall and F1.
"""

from __future__ import annotations

import numpy as np

#: attribute -> (minority code, majority code); -1 is a missing value
DI_GROUPS = {"skin_tone": (1, 0), "sex": (1, 0), "control": (0, 1)}


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """The Mann-Whitney AUC with midranks for ties; NaN without both
    classes."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int((labels == 1).sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    values, inverse, counts = np.unique(scores, return_inverse=True,
                                        return_counts=True)
    ends = np.cumsum(counts)
    midrank = ends - (counts - 1) / 2.0     # 1-based midrank of each value
    rank_sum = midrank[inverse][labels == 1].sum()
    return float((rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _rate(num: int, den: int) -> float:
    return num / den if den else 0.0


def _prf(tp: int, fp: int, fn: int) -> tuple[float, float, float]:
    if tp <= 0:
        return 0.0, 0.0, 0.0
    p, r = tp / (tp + fp), tp / (tp + fn)
    return p, r, 2 * ((p * r) / (p + r))


def disparate_impact(mn: tuple[int, ...], mj: tuple[int, ...]) -> dict:
    """The DI dict of a minority's and a majority's (tp, tn, fp, fn)."""
    tp_min, tn_min, fp_min, fn_min = mn
    tp_maj, tn_maj, fp_maj, fn_maj = mj
    tp, tn, fp, fn = (a + b for a, b in zip(mn, mj))
    min_count, maj_count = sum(mn), sum(mj)
    sel_min = _rate(tp_min + fp_min, min_count)
    sel_maj = _rate(tp_maj + fp_maj, maj_count)
    precision, recall, f1 = _prf(tp, fp, fn)
    min_p, min_r, min_f = _prf(tp_min, fp_min, fn_min)
    maj_p, maj_r, maj_f = _prf(tp_maj, fp_maj, fn_maj)
    return {
        "accuracy": _rate(tp + tn, tp + tn + fp + fn),
        "precision": precision, "recall": recall, "f1": f1,
        "selection_rate_min": sel_min, "selection_rate_maj": sel_maj,
        "di": sel_min / sel_maj if sel_maj > 0.0 else 0.0,
        "min_prevalence": _rate(tp_min + fn_min, min_count),
        "maj_prevalence": _rate(tp_maj + fn_maj, maj_count),
        "min_selected": tp_min + fp_min, "min_count": min_count,
        "maj_selected": tp_maj + fp_maj, "maj_count": maj_count,
        "min_precision": min_p, "min_recall": min_r, "min_f1": min_f,
        "maj_precision": maj_p, "maj_recall": maj_r, "maj_f1": maj_f,
        "tp_min": tp_min, "tn_min": tn_min, "fp_min": fp_min,
        "fn_min": fn_min, "tp_maj": tp_maj, "tn_maj": tn_maj,
        "fp_maj": fp_maj, "fn_maj": fn_maj,
    }


def _confusion(preds: np.ndarray, labels: np.ndarray) -> tuple[int, ...]:
    return (int(((preds == 1) & (labels == 1)).sum()),
            int(((preds == 0) & (labels == 0)).sum()),
            int(((preds == 1) & (labels == 0)).sum()),
            int(((preds == 0) & (labels == 1)).sum()))


def fairness_record(preds: np.ndarray, scores: np.ndarray,
                    labels: np.ndarray, groups: dict) -> dict:
    """The flagship's record over rows ``0..N-1`` of the test split."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    rec: dict = {"correct": int((preds == labels).sum()),
                 "total": int(labels.size)}
    rec["accuracy"] = rec["correct"] / rec["total"]
    tone, sex = np.asarray(groups["skin_tone"]), np.asarray(groups["sex"])
    rec.update(dark=int((tone == 1).sum()), light=int((tone == 0).sum()),
               male=int((sex == 0).sum()), female=int((sex == 1).sum()))
    for key, attr in (("tone_di_results", "skin_tone"),
                      ("gender_di_results", "sex"),
                      ("control_di_results", "control")):
        codes = np.asarray(groups[attr])
        mn, mj = DI_GROUPS[attr]
        rec[key] = disparate_impact(
            _confusion(preds[codes == mn], labels[codes == mn]),
            _confusion(preds[codes == mj], labels[codes == mj]))
    rec["auc"] = auc(labels, scores)
    t = rec["tone_di_results"]
    acc_dark = _rate(t["tp_min"] + t["tn_min"], t["min_count"])
    acc_light = _rate(t["tp_maj"] + t["tn_maj"], t["maj_count"])
    rec["tone_accuracy_dark"] = acc_dark
    rec["tone_accuracy_light"] = acc_light
    rec["tone_accuracy_gap"] = acc_dark - acc_light
    rec["auc_dark"] = auc(labels[tone == 1], scores[tone == 1])
    rec["auc_light"] = auc(labels[tone == 0], scores[tone == 0])
    return rec


def multiclass_record(preds: np.ndarray, labels: np.ndarray,
                      n_classes: int) -> dict:
    """Accuracy and macro precision, recall and F1 (0 where undefined)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    ps, rs, fs = [], [], []
    for c in range(n_classes):
        tp = int(((preds == c) & (labels == c)).sum())
        fp = int(((preds == c) & (labels != c)).sum())
        fn = int(((preds != c) & (labels == c)).sum())
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        ps.append(p)
        rs.append(r)
        fs.append(2 * p * r / (p + r) if p + r else 0.0)
    return {"accuracy": float((preds == labels).mean()),
            "precision": float(np.mean(ps)), "recall": float(np.mean(rs)),
            "f1": float(np.mean(fs))}


def flat(record: dict, prefix: str = "") -> dict[str, float]:
    """A record's numbers by dotted key."""
    out: dict[str, float] = {}
    for k, v in record.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = float(v)
    return out


def record_gap(got: dict, want: dict) -> float:
    """The largest absolute difference over the numbers of two records
    (both NaN counts as equal; a key in one alone as infinite)."""
    a, b = flat(got), flat(want)
    if set(a) != set(b):
        return float("inf")
    gap = 0.0
    for k in a:
        x, y = a[k], b[k]
        if np.isnan(x) and np.isnan(y):
            continue
        gap = max(gap, abs(x - y)) if not (np.isnan(x) or np.isnan(y)) \
            else float("inf")
    return gap

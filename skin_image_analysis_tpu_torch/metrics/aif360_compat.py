"""aif360-compatible fairness metrics from confusion counts (the port's
copy of the JAX package's ``metrics.aif360_compat``, which imports
nothing of JAX).

The reference's legacy monolith computes statistical_parity_difference,
disparate_impact and equal_opportunity_difference through IBM's aif360
``BinaryLabelDatasetMetric``/``ClassificationMetric``
(tone_bias_torch.py:1591-1621) before the custom DI derivation replaced it
(comment tone_bias_test.py:162-164). These are the same formulas computed
directly from the integer confusion counts the rest of the metrics layer
already produces — no aif360 dependency, identical numbers.

Conventions (aif360): 'unprivileged' = the minority group argument,
'privileged' = majority; favorable outcome = positive prediction.
"""

from __future__ import annotations


def _rates(tp: int, tn: int, fp: int, fn: int) -> dict:
    n = tp + tn + fp + fn
    pos = tp + fn
    return {
        "selection_rate": (tp + fp) / n if n else 0.0,
        "tpr": tp / pos if pos else 0.0,
        "fpr": fp / (fp + tn) if (fp + tn) else 0.0,
        "base_rate": pos / n if n else 0.0,
    }


def statistical_parity_difference(
    tp_min, tn_min, fp_min, fn_min, tp_maj, tn_maj, fp_maj, fn_maj
) -> float:
    """P(pred=1 | unprivileged) - P(pred=1 | privileged)."""
    a = _rates(tp_min, tn_min, fp_min, fn_min)
    b = _rates(tp_maj, tn_maj, fp_maj, fn_maj)
    return a["selection_rate"] - b["selection_rate"]


def disparate_impact(
    tp_min, tn_min, fp_min, fn_min, tp_maj, tn_maj, fp_maj, fn_maj
) -> float:
    """Selection-rate ratio min/maj (0.0 when the majority rate is 0,
    matching the main metric layer's zero-guard)."""
    a = _rates(tp_min, tn_min, fp_min, fn_min)
    b = _rates(tp_maj, tn_maj, fp_maj, fn_maj)
    if b["selection_rate"] == 0.0:
        return 0.0
    return a["selection_rate"] / b["selection_rate"]


def equal_opportunity_difference(
    tp_min, tn_min, fp_min, fn_min, tp_maj, tn_maj, fp_maj, fn_maj
) -> float:
    """TPR(unprivileged) - TPR(privileged)."""
    a = _rates(tp_min, tn_min, fp_min, fn_min)
    b = _rates(tp_maj, tn_maj, fp_maj, fn_maj)
    return a["tpr"] - b["tpr"]


def average_odds_difference(
    tp_min, tn_min, fp_min, fn_min, tp_maj, tn_maj, fp_maj, fn_maj
) -> float:
    """0.5 * [(FPR_min - FPR_maj) + (TPR_min - TPR_maj)]."""
    a = _rates(tp_min, tn_min, fp_min, fn_min)
    b = _rates(tp_maj, tn_maj, fp_maj, fn_maj)
    return 0.5 * ((a["fpr"] - b["fpr"]) + (a["tpr"] - b["tpr"]))


def classification_metric_report(di_results: dict) -> dict:
    """Full aif360-style report from a metric-layer DI dict
    (metrics.fairness.di_from_counts output)."""
    counts = (
        di_results["tp_min"], di_results["tn_min"],
        di_results["fp_min"], di_results["fn_min"],
        di_results["tp_maj"], di_results["tn_maj"],
        di_results["fp_maj"], di_results["fn_maj"],
    )
    return {
        "statistical_parity_difference": statistical_parity_difference(*counts),
        "disparate_impact": disparate_impact(*counts),
        "equal_opportunity_difference": equal_opportunity_difference(*counts),
        "average_odds_difference": average_odds_difference(*counts),
    }

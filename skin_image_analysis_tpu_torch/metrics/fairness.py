"""Disparate-impact fairness metrics, bit-compatible with the JAX
package's ``metrics.fairness`` (a copy of ``di_from_counts`` and
``analyse_predictions``).

'malignant' is the positive class; selection rate = (TP + FP) / group
count; DI = selection_rate_min / selection_rate_maj (0.0 when the
majority rate is 0); precision/recall/F1 are zero-guarded on TP > 0, and
rates over an empty group report 0.0.
"""

from __future__ import annotations

from typing import Any, Mapping

Instances = Mapping[int, Mapping[str, Any]]


def confusion_matrix(instances: Instances):
    """Partition instances into (tp, tn, fp, fn) dicts, malignant =
    positive."""
    tp, tn, fp, fn = {}, {}, {}, {}
    for index in sorted(instances.keys()):
        inst = instances[index]
        pred, label = inst["prediction"], inst["benign_malignant"]
        if pred == "malignant" and label == "malignant":
            tp[index] = inst
        elif pred == "benign" and label == "benign":
            tn[index] = inst
        elif pred == "malignant" and label == "benign":
            fp[index] = inst
        elif pred == "benign" and label == "malignant":
            fn[index] = inst
    if len(tp) + len(tn) + len(fp) + len(fn) != len(instances):
        raise ValueError(
            f"tp={len(tp)} + tn={len(tn)} + fp={len(fp)} + fn={len(fn)}"
            f" != {len(instances)}"
        )
    return tp, tn, fp, fn


def values_counts(instances: Instances, feature: str, value: Any) -> int:
    return sum(1 for i in instances if instances[i][feature] == value)


def filter_instances(instances: Instances, feature: str, value: Any) -> dict:
    return {i: inst for i, inst in instances.items() if inst[feature] == value}


def di_from_counts(
    tp_min: int, tn_min: int, fp_min: int, fn_min: int,
    tp_maj: int, tn_maj: int, fp_maj: int, fn_maj: int,
) -> dict:
    """The disparate-impact metric dict from raw per-group confusion
    counts."""
    tp, tn = tp_min + tp_maj, tn_min + tn_maj
    fp, fn = fp_min + fp_maj, fn_min + fn_maj

    total = tp + tn + fp + fn
    accuracy = (tp + tn) / total if total else 0.0
    precision = recall = f1 = 0.0
    if tp > 0:
        precision = tp / (tp + fp)
        recall = tp / (tp + fn)
        f1 = 2 * ((precision * recall) / (precision + recall))

    min_count = tp_min + tn_min + fp_min + fn_min
    maj_count = tp_maj + tn_maj + fp_maj + fn_maj

    min_selected = tp_min + fp_min
    maj_selected = tp_maj + fp_maj
    selection_rate_min = min_selected / min_count if min_count else 0.0
    selection_rate_maj = maj_selected / maj_count if maj_count else 0.0

    min_prevalence = (tp_min + fn_min) / min_count if min_count else 0.0
    maj_prevalence = (tp_maj + fn_maj) / maj_count if maj_count else 0.0

    min_precision = min_recall = min_f1 = 0.0
    if tp_min > 0:
        min_precision = tp_min / (tp_min + fp_min)
        min_recall = tp_min / (tp_min + fn_min)
        min_f1 = 2 * ((min_precision * min_recall)
                      / (min_precision + min_recall))

    maj_precision = maj_recall = maj_f1 = 0.0
    if tp_maj > 0:
        maj_precision = tp_maj / (tp_maj + fp_maj)
        maj_recall = tp_maj / (tp_maj + fn_maj)
        maj_f1 = 2 * ((maj_precision * maj_recall)
                      / (maj_precision + maj_recall))

    di = 0.0
    if selection_rate_maj > 0.0:
        di = selection_rate_min / selection_rate_maj

    return {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "selection_rate_min": selection_rate_min,
        "selection_rate_maj": selection_rate_maj,
        "di": di,
        "min_prevalence": min_prevalence,
        "maj_prevalence": maj_prevalence,
        "min_selected": min_selected,
        "min_count": min_count,
        "maj_selected": maj_selected,
        "maj_count": maj_count,
        "min_precision": min_precision,
        "min_recall": min_recall,
        "min_f1": min_f1,
        "maj_precision": maj_precision,
        "maj_recall": maj_recall,
        "maj_f1": maj_f1,
        "tp_min": tp_min,
        "tn_min": tn_min,
        "fp_min": fp_min,
        "fn_min": fn_min,
        "tp_maj": tp_maj,
        "tn_maj": tn_maj,
        "fp_maj": fp_maj,
        "fn_maj": fn_maj,
    }


def disparate_impact_analysis(min_instances: Instances,
                              maj_instances: Instances) -> dict:
    """DI analysis over instance dicts."""
    tp_min, tn_min, fp_min, fn_min = confusion_matrix(min_instances)
    tp_maj, tn_maj, fp_maj, fn_maj = confusion_matrix(maj_instances)
    return di_from_counts(
        len(tp_min), len(tn_min), len(fp_min), len(fn_min),
        len(tp_maj), len(tn_maj), len(fp_maj), len(fn_maj),
    )


def analyse_predictions(instances: Instances, verbose: bool = False) -> dict:
    """Full fairness audit -> the per-epoch record dict: DI for skin tone
    (dark vs light), gender (female vs male) and the placebo control (poor
    vs rich)."""
    correct = sum(
        1
        for i in instances
        if instances[i]["prediction"] == instances[i]["benign_malignant"]
    )
    total = len(instances)
    if verbose:
        print(f"Total={total} correct={correct} accuracy={correct / total:.3f}")

    dark = filter_instances(instances, "skin_tone", "dark")
    light = filter_instances(instances, "skin_tone", "light")
    male = filter_instances(instances, "sex", "male")
    female = filter_instances(instances, "sex", "female")
    poor = filter_instances(instances, "control", "poor")
    rich = filter_instances(instances, "control", "rich")

    return {
        "correct": correct,
        "total": total,
        "accuracy": correct / total,
        "dark": len(dark),
        "light": len(light),
        "male": len(male),
        "female": len(female),
        "tone_di_results": disparate_impact_analysis(dark, light),
        "gender_di_results": disparate_impact_analysis(female, male),
        "control_di_results": disparate_impact_analysis(poor, rich),
    }

"""Aggregation of experiment results (port of the JAX package's
``analysis.experiments``).

- :func:`read_experiment` reads the epoch records of one experiment
  folder, its timestamped files in name order (a resumed run's files
  concatenate), flattens each record and numbers the epochs across the
  files (``global_epoch``);
- :func:`read_experiments` averages every numeric measure per epoch over
  the runs whose folder names share a prefix (``balanced``,
  ``imbalanced``), with confidence intervals;
- :func:`compute_ci` takes the t distribution up to n = 30, the normal
  above.
"""

from __future__ import annotations

import glob
import math
import os
from collections import defaultdict
from typing import Any, Sequence

from skin_image_analysis_tpu_torch.utils import jsonl

# two-sided critical values of the normal at the given confidence level
_Z = {0.90: 1.6448536269514722, 0.95: 1.959963984540054,
      0.99: 2.5758293035489004}


def _t_critical(df: int, level: float) -> float:
    """Two-sided t critical value: scipy's quantile where scipy is
    installed, else a table of the 90% values."""
    try:
        from scipy import stats
    except ImportError:
        table90 = {1: 6.314, 2: 2.920, 3: 2.353, 4: 2.132, 5: 2.015,
                   10: 1.812, 20: 1.725, 30: 1.697}
        for k in sorted(table90):
            if df <= k:
                return table90[k]
        return _Z[0.90]
    return float(stats.t.ppf((1 + level) / 2, df))


def compute_ci(data: Sequence[float],
               level: float = 0.90) -> tuple[float, float]:
    """(mean - margin, mean + margin), the margin the t (n <= 30) or
    normal critical value times the standard error."""
    n = len(data)
    mean = sum(data) / n
    if n < 2:
        return (mean, mean)
    var = sum((x - mean) ** 2 for x in data) / (n - 1)
    sem = math.sqrt(var / n)
    crit = _t_critical(n - 1, level) if n <= 30 else _Z.get(level, 1.645)
    return (mean - crit * sem, mean + crit * sem)


def transpose_dict(records: Sequence[dict]) -> dict[str, list]:
    """A list of dicts -> a dict of lists."""
    out: dict[str, list] = defaultdict(list)
    for rec in records:
        for k, v in rec.items():
            out[k].append(v)
    return dict(out)


def flatten_record(record: dict) -> dict[str, Any]:
    """One epoch record -> its scalar measures plus the reference's
    derived keys (``tone_di``, ``f1``, ``gender_di``, ...)."""
    tone = record.get("tone_di_results", {})
    gender = record.get("gender_di_results", {})
    control = record.get("control_di_results", {})
    flat = {k: v for k, v in record.items() if not isinstance(v, dict)}
    flat.update({
        "tone_di_selection_rate_min": tone.get("selection_rate_min"),
        "tone_di_selection_rate_maj": tone.get("selection_rate_maj"),
        "tone_di": tone.get("di"),
        "f1": tone.get("f1"),
        "gender_di": gender.get("di"),
        "control_di": control.get("di"),
    })
    return flat


def read_experiment(exp_path: str) -> list[dict]:
    """Every epoch record of one experiment, flattened, with
    ``global_epoch``."""
    records: list[dict] = []
    for path in jsonl.read_experiment_files(exp_path):
        if not os.path.basename(path)[0].isdigit():
            continue  # train_config.json and the like
        records.extend(flatten_record(rec)
                       for rec in jsonl.read_records(path))
    for global_epoch, rec in enumerate(records):
        rec["global_epoch"] = global_epoch
    return records


def read_experiments(folder: str, prefix: str,
                     level: float = 0.90) -> dict[str, Any]:
    """The experiments under ``folder`` whose names start with
    ``prefix``: per epoch, the mean of every numeric measure over the runs
    (NaNs left out) and its confidence interval."""
    exp_paths = sorted(p for p in glob.glob(os.path.join(folder,
                                                         f"{prefix}*"))
                       if os.path.isdir(p))
    runs = [r for r in (read_experiment(p) for p in exp_paths) if r]
    if not runs:
        return {"experiments": exp_paths, "epochs": [], "mean": {}, "ci": {}}

    n_epochs = max(len(r) for r in runs)
    values: dict[str, list[list[float]]] = defaultdict(
        lambda: [[] for _ in range(n_epochs)])
    for run in runs:
        for epoch, rec in enumerate(run):
            for k, v in rec.items():
                if isinstance(v, (int, float)) and not (
                        isinstance(v, float) and math.isnan(v)):
                    values[k][epoch].append(float(v))

    mean = {k: [sum(vs) / len(vs) if vs else float("nan")
                for vs in per_epoch]
            for k, per_epoch in values.items()}
    ci = {k: [compute_ci(vs, level) if vs else (float("nan"), float("nan"))
              for vs in per_epoch]
          for k, per_epoch in values.items()}
    return {"experiments": exp_paths, "epochs": list(range(n_epochs)),
            "mean": mean, "ci": ci, "n_runs": len(runs)}

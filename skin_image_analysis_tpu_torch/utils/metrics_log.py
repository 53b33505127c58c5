"""Run-metrics logger with wandb's ``log(dict, step=)`` surface, and the
per-epoch binary metrics (a copy of the JAX package's
``utils.metrics_log``).

:class:`MetricsLogger` appends one JSON record per call to
``<out_dir>/metrics.jsonl`` (``step``, ``ts`` and the metrics), and
forwards to wandb where that package is importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

import numpy as np


class MetricsLogger:
    def __init__(self, out_dir: str, project: str = "tone-classifier",
                 run_name: str | None = None, use_wandb: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._file = open(self.path, "a")
        self._step = 0
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=project, name=run_name, dir=out_dir
                )
            except Exception:
                self._wandb = None

    def log(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        step = self._step if step is None else step
        self._step = step + 1
        record = {"step": step, "ts": time.time(), **metrics}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def finish(self) -> None:
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()


def binary_metrics(preds, labels) -> dict[str, float]:
    """Accuracy, precision, recall and F1 with class 1 positive (sklearn's
    defaults)."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    tp = int(((preds == 1) & (labels == 1)).sum())
    fp = int(((preds == 1) & (labels == 0)).sum())
    fn = int(((preds == 0) & (labels == 1)).sum())
    accuracy = float((preds == labels).mean()) if preds.size else 0.0
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"accuracy": accuracy, "precision": precision,
            "recall": recall, "f1": f1}

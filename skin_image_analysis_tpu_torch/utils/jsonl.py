"""JSON-lines experiment records (port of the JAX package's
``utils.jsonl``): one JSON object per epoch, numpy and torch scalars
coerced to plain Python numbers."""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

import numpy as np


def _coerce(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _coerce(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_coerce(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return _coerce(obj.tolist())
    if hasattr(obj, "tolist") and not isinstance(obj, (str, bytes)):
        return _coerce(obj.tolist())
    return obj


def append_record(path: str, record: dict) -> None:
    """Append one JSON line (creating the file if needed)."""
    with open(path, "a") as f:
        f.write(json.dumps(_coerce(record)))
        f.write("\n")


def read_records(path: str) -> Iterator[dict]:
    """Yield one dict per parseable JSON line; a truncated last line (a
    run killed mid-append) is skipped."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue


def read_experiment_files(folder: str) -> list[str]:
    """All ``*.json`` record files of an experiment folder, sorted by
    their timestamp names, so that a resumed run's files concatenate in
    order."""
    names = sorted(n for n in os.listdir(folder) if n.endswith(".json"))
    return [os.path.join(folder, n) for n in names]

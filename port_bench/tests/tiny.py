"""A cell's spec shrunk to a size the CPU tests can hold: few rows, small
frames, a small batch, the model's widths unchanged."""

from __future__ import annotations

import copy
from pathlib import Path

from port_bench.run import load_spec

ROOT = Path(__file__).resolve().parents[2]


def tiny_spec(workload: str, frame: int = 40, image: int = 32,
              batch: int = 8) -> dict:
    """Enough rows a class for four train batches and a partial audit
    batch."""
    spec = copy.deepcopy(load_spec(ROOT, workload))
    t = spec["traffic"]
    n_classes = len(t["counts"])
    rows_per_class = -(-(4 * batch + 3) // (t["split"] * n_classes))
    rows_per_class = int(rows_per_class)
    t["counts"] = [rows_per_class] * n_classes
    t["rows"] = rows_per_class * n_classes
    t["frame"], t["batch_size"] = frame, batch
    for g in t.get("groups", {}).values():
        share = [c / sum(g["counts"]) for c in g["counts"]]
        counts = [int(s * t["rows"]) for s in share]
        counts[0] += t["rows"] - sum(counts)
        g["counts"] = counts
    cfg = spec["config"]
    cfg["model"]["image_size"] = image
    program = cfg["program"]
    if "classify" in program:
        program["classify"].update(image_size=image, canonical_size=frame)
    else:
        program["model"]["image_size"] = image
        program["data"].update(image_size=image, canonical_size=frame)
    return spec

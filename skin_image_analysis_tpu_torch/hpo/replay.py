"""Replay hyper-parameter artifacts — ours and the reference's (a copy of
the JAX package's ``hpo.replay``).

The reference saves its winning trial as
``optuna_{TRIALS}_{EPOCHS}_{DEVICE}_{BATCHSIZE}_{SAMPLE_SIZE}.json``
written by a hand-rolled formatter (tone_bias_optuna.py:327-341) that is
NOT valid JSON: single-quoted keys, values emitted with bare ``str()``
(so the DEVICE value appears unquoted, e.g. ``'DEVICE': mps,``), a
trailing comma, and no newlines. A reference user migrating here brings
those files; this module parses them tolerantly, renames the reference's
search-space parameters into ours (hpo.space.define_isic_model), and
replays them into a (ModelConfig, OptimConfig) pair.

Our own sweep artifacts (cli/tone_bias_optuna.py — real JSON with a
``best_params`` dict already in our naming) replay through the same
entry point.
"""

from __future__ import annotations

import json
import re
from typing import Any

from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig

__all__ = [
    "parse_reference_artifact",
    "reference_params_to_ours",
    "replay_artifact",
]

# run-constant keys the reference appends to trial.params before saving
_RUN_KEYS = {"TRIALS", "EPOCHS", "DEVICE", "BATCHSIZE", "SAMPLE_SIZE"}

_PAIR = re.compile(r"'([^']+)'\s*:\s*([^,}]+)")


def _coerce(raw: str) -> Any:
    raw = raw.strip()
    if raw.startswith(("'", '"')) and raw.endswith(("'", '"')) and len(raw) > 1:
        return raw[1:-1]
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw  # bare word (the unquoted DEVICE value)


def parse_reference_artifact(path: str) -> dict[str, Any]:
    """Parse an ``optuna_*.json`` file from either framework into a flat
    params dict. Accepts real JSON (our artifacts) and the reference's
    pseudo-dict format."""
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
        if isinstance(data, dict):
            return data
    except json.JSONDecodeError:
        pass
    pairs = _PAIR.findall(text)
    if not pairs:
        raise ValueError(
            f"{path}: neither JSON nor the reference's optuna artifact "
            "format"
        )
    return {key: _coerce(value) for key, value in pairs}


def reference_params_to_ours(params: dict[str, Any]) -> dict[str, Any]:
    """Rename the reference search space's parameter names
    (tone_bias_optuna.py:123-173: ``n_units_l0``, ``n_units_conv_l{i}``,
    ``n_units_linear_l{i}``, ``dropout_l{i}``, torch-cased optimizer)
    into ours (hpo.space.define_isic_model). Already-ours names pass
    through unchanged, so the function is idempotent."""
    out: dict[str, Any] = {}
    for key, value in params.items():
        if key in _RUN_KEYS:
            continue
        m = re.fullmatch(r"n_units_l0", key)
        if m:
            out["first_conv_out"] = value
            continue
        m = re.fullmatch(r"n_units_conv_l(\d+)", key)
        if m:
            out[f"conv_out_{m.group(1)}"] = value
            continue
        m = re.fullmatch(r"n_units_linear_l(\d+)", key)
        if m:
            out[f"linear_out_{m.group(1)}"] = value
            continue
        m = re.fullmatch(r"dropout_l(\d+)", key)
        if m:
            out[f"dropout_{m.group(1)}"] = value
            continue
        if key == "optimizer":
            out["optimizer"] = str(value).lower()
            continue
        out[key] = value
    return out


def replay_artifact(
    path: str, image_size: int = 224, compute_dtype: str = "bfloat16",
    classes: int = 2,
) -> tuple[ModelConfig, OptimConfig]:
    """Rebuild the winning (ModelConfig, OptimConfig) from a sweep
    artifact of either framework — the reference's ``create_best_model``
    flow (tone_bias_optuna.py:116-121) pointed at a file instead of
    hard-coded constants."""
    from skin_image_analysis_tpu_torch.hpo.space import define_isic_model
    from skin_image_analysis_tpu_torch.hpo.study import TrialReplay

    raw = parse_reference_artifact(path)
    if "best_params" in raw and isinstance(raw["best_params"], dict):
        raw = raw["best_params"]  # our artifact schema
    params = reference_params_to_ours(raw)
    if "optimizer" not in params:
        params["optimizer"] = "adam"  # reference default path
    return define_isic_model(
        TrialReplay(params), classes=classes, image_size=image_size,
        compute_dtype=compute_dtype,
    )

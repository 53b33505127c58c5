"""The comparison that decides ``correct``.

The reference (``port_bench.reference``) follows the program's first
three train steps from the benchmark's weights, with the same rows and
the same draws, and recomputes the audit of those weights over the whole
test split. Each number below compares a reading of the program (or of
a stand-in, such as the control) with the reference's; each has a limit
in the cell's workload file, and the run is correct when every number is
finite and within its limit.

- ``loss_gap``: the largest relative gap of a step's loss;
  ``first_loss_gap`` the first step's alone (the weights both sides
  start from: no later step's noise in it).
- ``grad_gap``: by the worst leaf, the gap between the norm of the first
  gradient as the optimizer got it and the reference's, over the larger
  of the reference's norm of that leaf and of the median leaf.
- ``grad_median_gap``: the median leaf's gap of the same norms, a
  steadier reading where the worst leaf's is the noise of a cancelling
  sum (a BatchNorm bias under the next BatchNorm's mean subtraction).
- ``update_gap``: the same for each parameter's change over the three
  steps. Leaves whose reference gradient is below a thousandth of the
  median leaf's move by round-off alone and are left out; leaves the
  reference does not train are held to no change.
- ``stats_gap``: the same for each BatchNorm statistic's change (models
  with BatchNorm).
- ``input_gap``: the largest absolute gap of the first step's model
  input (the preprocess output).
- ``audit_prob_gap``: the largest absolute gap of a class probability
  over the audit's rows; ``audit_prob_rms_gap`` the root mean square of
  those gaps, steady from seed to seed where the largest swings.
- ``audit_record_gap``: the largest gap between the audit's record and
  the record the reference computes from the audit's own per-row
  predictions and scores: its semantics, compared exactly.

A cell's workload file names the numbers it compares, each with its
limit; the others are printed as readings only.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from port_bench.epochs import (
    DRAWS_SEED,
    VERIFY_STEPS,
    Readings,
    derived_seed,
    norm,
)
from port_bench.reference import audit, preprocess
from port_bench.reference.precision import Precision, float32_math
from port_bench.reference.train import Batch, eval_log_probs, train_steps

#: rows of the reference's eval blocks
EVAL_BLOCK = 256
#: a leaf whose reference gradient norm is below this share of the median
#: leaf's moves by round-off alone
ROUNDOFF_SHARE = 1e-3


def _leaf_gaps(got: dict, want: dict, leaves) -> list[float]:
    """Each leaf's gap of norms over ``leaves``, against the larger of the
    leaf's reference norm and the median reference norm of the leaves
    that move; [inf] when a leaf is missing."""
    leaves = list(leaves)
    if not leaves or any(n not in got or n not in want for n in leaves):
        return [math.inf]
    moving = [want[n] for n in leaves if want[n] > 0.0]
    med = statistics.median(moving) if moving else 0.0
    gaps = []
    for n in leaves:
        den = max(want[n], med)
        gap = abs(got[n] - want[n])
        gaps.append(gap / den if den > 0 else (0.0 if gap == 0
                                                else math.inf))
    return gaps


def _leaf_gap(got: dict, want: dict, leaves) -> float:
    """The worst leaf's gap (``_leaf_gaps``)."""
    return max(_leaf_gaps(got, want, leaves))


def reference_readings(cell, prec: Precision,
                       half_batch: bool = False) -> Readings:
    """The reference's readings of ``cell`` (after its program state is
    released) in precision ``prec``. ``half_batch`` plants a fault: each
    step's loss left out the second half of its rows."""
    cfg, mod = cell.model_cfg, cell.reference
    c = cell.cohort
    dev = c.train_arena.device
    gen = torch.Generator(device=dev).manual_seed(
        derived_seed(cell.seed, DRAWS_SEED))
    widths = mod.dropout_widths(cfg)
    s = c.train_arena.shape[-1]
    draws = [preprocess.draw_step(gen, cell.batch, s, cfg["image_size"],
                                  cell.spec["config"]["augment"], widths)
             for _ in range(VERIFY_STEPS)]
    batches = []
    for rows in cell.verify_rows:
        valid = torch.ones(len(rows), dtype=torch.bool, device=dev)
        if half_batch:
            valid[len(rows) // 2:] = False
        batches.append(Batch(torch.from_numpy(rows).to(dev),
                             torch.from_numpy(c.train_labels[rows]).to(dev),
                             valid))
    weights = None
    if cfg.get("class_weights") == "balanced":
        counts = np.bincount(c.train_labels, minlength=cfg["num_classes"])
        weights = torch.tensor(len(c.train_labels)
                               / (cfg["num_classes"] * counts),
                               dtype=torch.float32, device=dev)
    with float32_math():
        done = train_steps(mod, cfg, cell.weights, c.train_arena, batches,
                           draws, weights, cell.spec["config"]["optim"],
                           prec)
        log_probs = eval_log_probs(mod, cfg, cell.weights, c.test_arena,
                                   c.test_arena.shape[0], EVAL_BLOCK, prec)
    stat = getattr(mod, "is_statistic", lambda n: False)
    w0 = cell.weights
    return Readings(
        losses=done.losses,
        grad_norms={n: norm(g) for n, g in done.first_grads.items()},
        delta_norms={n: norm(done.params[n] - w0[n]) for n in w0
                     if not stat(n)},
        stat_norms={n: norm(done.params[n] - w0[n]) for n in w0 if stat(n)},
        inputs=done.inputs, log_probs=log_probs.cpu(), record={})


def audit_record_of(cell, log_probs: torch.Tensor) -> dict:
    """The record the reference computes from per-row log-probs (their
    argmax is the prediction; the malignant score their exp)."""
    lp = log_probs.cpu().numpy()
    preds = lp.argmax(axis=1)
    c = cell.cohort
    if cell.model_cfg["num_classes"] == 2 and c.test_groups:
        return audit.fairness_record(preds, np.exp(lp[:, 1]), c.test_labels,
                                     c.test_groups)
    return audit.multiclass_record(preds, c.test_labels,
                                   cell.model_cfg["num_classes"])


def numbers(cell, got: Readings, want: Readings) -> dict[str, float]:
    """Each compared number of ``got`` against the reference's ``want``."""
    out = {"loss_gap": max(
        (abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses)),
        default=math.inf) if len(got.losses) == len(want.losses)
        else math.inf}
    out["first_loss_gap"] = (abs(got.losses[0] - want.losses[0])
                             / abs(want.losses[0]) if got.losses
                             and want.losses else math.inf)
    same = set(got.grad_norms) == set(want.grad_norms)
    gaps = (_leaf_gaps(got.grad_norms, want.grad_norms, want.grad_norms)
            if same else [math.inf])
    out["grad_gap"] = max(gaps)
    out["grad_median_gap"] = statistics.median(gaps)
    moving = [want.grad_norms[n] for n in want.grad_norms]
    floor = ROUNDOFF_SHARE * statistics.median(moving) if moving else 0.0
    trained = set(want.grad_norms)
    kept = [n for n in want.delta_norms
            if n not in trained or want.grad_norms[n] >= floor]
    out["update_gap"] = _leaf_gap(got.delta_norms, want.delta_norms, kept)
    if want.stat_norms:
        out["stats_gap"] = _leaf_gap(got.stat_norms, want.stat_norms,
                                     want.stat_norms)
    if got.inputs is None or got.inputs.shape != want.inputs.shape:
        out["input_gap"] = math.inf
    else:
        out["input_gap"] = float((got.inputs.float()
                                  - want.inputs.float()).abs().max())
    if got.log_probs.shape != want.log_probs.shape:
        out["audit_prob_gap"] = out["audit_prob_rms_gap"] = math.inf
    else:
        gap = (got.log_probs.cpu().double().exp()
               - want.log_probs.cpu().double().exp())
        out["audit_prob_gap"] = float(gap.abs().max())
        out["audit_prob_rms_gap"] = float(gap.square().mean().sqrt())
    out["audit_record_gap"] = audit.record_gap(
        got.record, audit_record_of(cell, got.log_probs))
    return out


def judge(values: dict[str, float], limits: dict[str, float]) -> bool:
    """Correct when every number with a limit is there, finite and within
    its limit, and there is at least one."""
    if not limits or not set(limits) <= set(values):
        return False
    return all(math.isfinite(values[k]) and values[k] <= lim
               for k, lim in limits.items())

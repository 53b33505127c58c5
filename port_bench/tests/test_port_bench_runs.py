"""Whole runs of the harness at a size the CPU holds: the plain references
agree with the port, the control and each fault the cells can have come
out not correct, and nothing loads JAX, Flax, optax or the JAX package.

The runs skip the harness's look for a card (``run_cell`` on the CPU,
where every kernel of the port runs its plain twin); the limits are the
cells' own, set from the readings at the cells' sizes on the card.
"""

from __future__ import annotations

import subprocess
import sys
import time

import pytest
import torch

from port_bench import checks
from port_bench.calibrate import readings
from port_bench.reference import precision
from port_bench.run import run_cell
from port_bench.tests.tiny import ROOT, tiny_spec

CELLS = ("flagship-isic-train", "resnet50-ham-finetune",
         "resnet50-ham-frozen")


def _float32(spec: dict) -> dict:
    program = spec["config"]["program"]
    (program["classify"] if "classify" in program
     else program["model"])["compute_dtype"] = "float32"
    spec["config"]["model"]["preprocess_dtype"] = "float32"
    return spec


@pytest.mark.parametrize("cell,held", [
    ("flagship-isic-train", {"loss_gap": 1e-5, "grad_gap": 1e-5,
                             "update_gap": 1e-4, "input_gap": 1e-5,
                             "audit_prob_gap": 1e-5}),
    # the port's BatchNorm takes the variance as E[x^2] - E[x]^2, the
    # reference in two passes: at 8 rows of 1x1 maps in the last stage the
    # two part by up to 1e-4 in the first loss and 1e-2 in the gradients,
    # and a fine-tuned ResNet's later steps at this size are chaotic
    ("resnet50-ham-finetune", {"grad_gap": 2e-2, "input_gap": 1e-5,
                               "audit_prob_gap": 1e-5}),
    ("resnet50-ham-frozen", {"loss_gap": 1e-3, "grad_gap": 1e-3,
                             "update_gap": 1e-3, "stats_gap": 1e-3,
                             "input_gap": 1e-5, "audit_prob_gap": 1e-5}),
])
def test_reference_agrees_with_the_port_in_float32(cell, held):
    line = readings(_float32(tiny_spec(cell)), 5, False, device="cpu")
    got = line["program"]
    assert got["audit_record_gap"] == 0.0
    for name, tol in held.items():
        assert got[name] < tol, (name, got)
    prog, ref = line["losses"]
    assert abs(prog[0] - ref[0]) < 1e-4 * abs(ref[0])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits(cell):
    spec = tiny_spec(cell)
    line = readings(spec, 3, True, device="cpu")
    limits = spec["workload"]["checks"]
    assert not checks.judge(line["control"], limits), line["control"]
    assert not checks.judge(line["half_batch"], limits), line["half_batch"]


def _fault(monkeypatch, fault: str) -> None:
    """Break the timed path underneath the harness."""
    from skin_image_analysis_tpu_torch.train import state, step

    if fault == "state_unchanged":
        for cls in (state.Adam, state.AdamW):
            monkeypatch.setattr(cls, "step", lambda self, grads: None)
    elif fault == "half_batch":
        whole = step.masked_loss_and_metrics

        def half(log_probs, labels, valid=None, *args, **kwargs):
            valid = (torch.ones_like(labels, dtype=torch.bool)
                     if valid is None else valid.clone())
            valid[labels.shape[0] // 2:] = False
            return whole(log_probs, labels, valid, *args, **kwargs)

        monkeypatch.setattr(step, "masked_loss_and_metrics", half)
    elif fault == "answer_altered":
        from skin_image_analysis_tpu_torch.train import classify, evaluate

        record = evaluate.fairness_record

        def flip_one(preds, *args, **kwargs):
            preds = preds.copy()
            preds[0] = 1 - preds[0]
            return record(preds, *args, **kwargs)

        monkeypatch.setattr(evaluate, "fairness_record", flip_one)
        metrics = classify.multiclass_metrics

        def altered(preds, labels, n_classes):
            preds = preds.copy()
            preds[0] = (preds[0] + 1) % n_classes
            return metrics(preds, labels, n_classes)

        from port_bench.drivers import transfer_epochs

        monkeypatch.setattr(transfer_epochs, "multiclass_metrics", altered)


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    spec = tiny_spec(cell)
    _fault(monkeypatch, fault)
    result = run_cell(spec, 2**31 + 17, 0.2, trace=False, device="cpu",
                      t0=time.perf_counter())
    checked = result["checks"]
    assert list(result)[-1] == "checks"
    assert set(checked) == set(spec["workload"]["checks"])
    if fault == "none":
        assert all(v["value"] != "nan" for v in checked.values())
    else:
        assert result["correct"] is False, checked


def test_a_traced_run_reports_per_layer_metrics_and_no_forbidden_module():
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from port_bench.tests.tiny import tiny_spec\n"
        "from port_bench.run import run_cell, forbidden_modules\n"
        "for cell in %r:\n"
        "    r = run_cell(tiny_spec(cell), 9, 0.1, trace=True,\n"
        "                 device='cpu', t0=time.perf_counter())\n"
        "    assert set(r['metrics']) == {'step_ms', 'eval_ms'}, r\n"
        "print(forbidden_modules())\n" % (str(ROOT), CELLS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_harness_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "flagship-isic-train", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_small_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = tiny_spec(cell, frame=72, image=64, batch=16)
    result = run_cell(spec, 5, 0.5, trace=True, device="cuda",
                      t0=time.perf_counter())
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert result["metrics"]["kernels_per_step"]["value"] > 0


def test_control_rounding_is_one_step_below():
    x = torch.linspace(-3, 3, 1001)
    assert torch.equal(precision.bf16(x), x.to(torch.bfloat16).float())
    q = precision.fp8_e4m3(x)
    assert (q - x).abs().max() > (precision.bf16(x) - x).abs().max()

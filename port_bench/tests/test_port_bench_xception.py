"""The cell ``xception-ham-finetune`` at a size the CPU holds (Keras's
smallest input, 71², from 80² frames, B=8, the published widths and
depth): the plain reference agrees with the port in float32, the control
and each fault come out not correct by the cell's limits, a traced run
loads nothing it may not; and the depthwise convs' bound and the two
metrics that read it."""

from __future__ import annotations

import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from port_bench import checks, depthwise
from port_bench.calibrate import readings
from port_bench.metrics import depthwise_roofline, depthwise_share
from port_bench.peaks import for_device
from port_bench.reference import xception
from port_bench.run import load_spec, run_cell
from port_bench.tests.test_port_bench_runs import _fault, _float32
from port_bench.tests.tiny import ROOT, tiny_spec

CELL = "xception-ham-finetune"


def _tiny() -> dict:
    return tiny_spec(CELL, frame=80, image=71)


def test_reference_agrees_with_the_port_in_float32():
    """Readings at this size (seed 5): loss 9.1e-5 (the later steps after
    adamw's +-lr moves of round-off gradients; the first 0), worst leaf's
    gradient 2.8e-5 (the port's variance is E[x^2] - E[x]^2, the
    reference's two-pass), update 3.5e-3 (elements whose gradients are
    round-off flip their +-lr), statistics 8.5e-5, input 7.2e-7, audit
    2.6e-7."""
    line = readings(_float32(_tiny()), 5, False, device="cpu")
    got = line["program"]
    held = {"loss_gap": 1e-3, "grad_gap": 1e-3, "update_gap": 2e-2,
            "stats_gap": 1e-3, "input_gap": 1e-5, "audit_prob_gap": 1e-5}
    assert got["audit_record_gap"] == 0.0
    for name, tol in held.items():
        assert got[name] < tol, (name, got)
    prog, ref = line["losses"]
    assert abs(prog[0] - ref[0]) < 1e-4 * abs(ref[0])


def test_the_control_and_the_half_batch_fail_the_cells_limits():
    spec = _tiny()
    line = readings(spec, 3, True, device="cpu")
    limits = spec["workload"]["checks"]
    assert not checks.judge(line["control"], limits), line["control"]
    assert not checks.judge(line["half_batch"], limits), line["half_batch"]


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    spec = _tiny()
    _fault(monkeypatch, fault)
    result = run_cell(spec, 2**31 + 17, 0.2, trace=False, device="cpu",
                      t0=time.perf_counter())
    checked = result["checks"]
    assert set(checked) == set(spec["workload"]["checks"])
    if fault == "none":
        assert all(v["value"] != "nan" for v in checked.values())
    else:
        assert result["correct"] is False, checked


def test_a_traced_run_on_the_cpu_reports_no_device_metric():
    """Without a device trace the depthwise metrics have nothing to read
    and are left out; nothing loads JAX, Flax, optax or the JAX
    package."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from port_bench.tests.tiny import tiny_spec\n"
        "from port_bench.run import run_cell, forbidden_modules\n"
        "r = run_cell(tiny_spec(%r, frame=80, image=71), 9, 0.1,\n"
        "             trace=True, device='cpu', t0=time.perf_counter())\n"
        "assert set(r['metrics']) == {'step_ms', 'eval_ms'}, r\n"
        "print(forbidden_modules())\n" % (str(ROOT), CELL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_depthwise_bound_at_the_cells_sizes():
    """34 depthwise convs over 14,687,816 input elements an image at 299²:
    176.25 MB a trained image and 58.75 MB an audited one in bf16, 13.47 ms
    a B=256 step and 52.70 ms an audit of 3,005 rows at 3.35 TB/s."""
    cfg = load_spec(ROOT, CELL)["config"]["model"]
    layers = depthwise.layers(xception, cfg)
    assert len(layers) == 34
    assert sum(c * h * w for c, h, w, *_ in layers) == 14_687_816
    assert all((h, w) == (ho, wo) and n == 9 * c
               for c, h, w, ho, wo, n in layers)
    b = depthwise.bound(xception, cfg, 256, 2)
    assert (b.train_image, b.eval_image) == (176_253_792, 58_751_264)
    bw = for_device("NVIDIA H100 80GB HBM3")["memory_bytes_per_s"]
    assert round(b.epoch_bytes(1, 0, 0) / bw * 1e3, 2) == 13.47
    assert round(b.epoch_bytes(0, 1, 3005) / bw * 1e3, 2) == 52.70


def _run(groups: dict) -> SimpleNamespace:
    traced = SimpleNamespace(busy_s=2.0, steps=3, groups=groups,
                             calls={"audit": 1})
    return SimpleNamespace(traced=traced, audit_rows=10,
                           peaks=for_device("NVIDIA H100 80GB HBM3"))


def test_the_depthwise_readers(monkeypatch):
    bound = depthwise.Bound(100, 40, 6, 2, 4)
    monkeypatch.setattr(depthwise, "left", bound)
    run = _run({depthwise.GROUP: 0.5, "matmul (cuBLAS)": 1.0})
    assert depthwise_share.read(run) == pytest.approx(25.0)
    moved = 3 * (4 * 100 + 6) + (10 * 40 + 3 * 2)
    assert moved == bound.epoch_bytes(3, 1, 10)
    assert depthwise_roofline.read(run) == pytest.approx(
        100 * moved / 3.35e12 / 0.5)
    # no depthwise kernel in the trace, or no bound left: nothing to read
    run = _run({"matmul (cuBLAS)": 1.0})
    assert depthwise_share.read(run) is None
    assert depthwise_roofline.read(run) is None
    monkeypatch.setattr(depthwise, "left", None)
    run = _run({depthwise.GROUP: 0.5})
    assert depthwise_roofline.read(run) is None
    assert depthwise_share.read(SimpleNamespace(traced=None)) is None


def test_the_driver_leaves_the_bound_of_its_cell(monkeypatch):
    from port_bench.drivers import xception_epochs

    monkeypatch.setattr(depthwise, "left", None)
    spec = _tiny()
    cell = xception_epochs.Driver(spec, 7, "cpu")
    cell.setup()
    want = depthwise.bound(xception, spec["config"]["model"], 8, 2)
    assert depthwise.left == want

"""Every stage of the port's perf-attribution rig runs on the CPU at a
tiny size and prints its lines (the rig's times mean something only on
the card)."""

import json

import pytest

from skin_image_analysis_tpu_torch.tools import perf_attrib
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = ["--device", "cpu", "--batch-size", "2", "--image-size", "32",
        "--iters", "1", "--scan-len", "2"]


@pytest.mark.parametrize("stage", perf_attrib.STAGES)
def test_stage_runs_on_the_cpu_and_prints_its_lines(stage, capsys):
    lines = perf_attrib.run([stage, *TINY])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == lines and lines
    *timings, last = lines
    if stage == "cost":
        assert last["stage"] == "cost" and last["flops"] > 0
        return
    assert last["stage"] == "summary" and last["batch_size"] == 2
    assert timings and all(
        {"stage", "ms", "img_per_s", "note", "device"} <= set(ln)
        and ln["device"] == "cpu" and ln["ms"] > 0 for ln in timings)
    assert {ln["stage"] for ln in timings} == set(last) - {
        "stage", "batch_size", "device"}
    if stage == "pconv0":
        fwdbwd = [ln for ln in timings if ln["stage"] == "pconv0_fwdbwd"][0]
        assert min(fwdbwd["grad_cos_dw"], fwdbwd["grad_cos_db"]) > 0.999
        assert fwdbwd["calls"] == perf_attrib.WARMUP + 3
    if stage == "fwdplans":
        # every band size, float32 and bf16 x, each plan passed explicitly
        assert {ln["stage"] for ln in timings} == {
            f"fwd_r{rows}_{tag}" for rows in (4, 8, 16)
            for tag in ("f32", "bf16")}


def test_unknown_stage_is_refused(capsys):
    with pytest.raises(SystemExit):
        perf_attrib.parse_args(["bogus"])
    assert "unknown stages" in capsys.readouterr().err

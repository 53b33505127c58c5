"""The program's spans in a traced epoch, on a synthetic profile: the
accepted reduction (``port_bench.trace.reduce``) keeps the values it has
without them, and ``port_bench.program_spans`` gives them their kernels,
device time and idle gaps; then once on a cell at a size the CPU holds."""

from __future__ import annotations

import pytest
import torch

from port_bench import program_spans, trace
from port_bench.tests.tiny import tiny_spec

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
STEPS = 2


class Event:
    """The part of a kineto event that the reductions read."""

    def __init__(self, name, device, start, end, corr=0, linked=0,
                 user=False, thread=1):
        self._name, self._device = name, device
        self._start, self._end = start, end
        self._corr, self._linked, self._user = corr, linked, user
        self.thread = thread

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def is_user_annotation(self):
        return self._user


def _ranges(prefix, spans):
    return [Event(prefix + name, CPU, a, b, user=True)
            for name, rs in spans.items() for a, b in rs]


HARNESS = _ranges("port_bench.", {
    "shuffle": [(0, 10)], "train": [(10, 200)], "fetch": [(200, 210)],
    "audit": [(210, 300)], "preprocess": [(22, 30), (112, 120)]})
PROGRAM = _ranges("sia.", {
    "train.call": [(12, 196)], "train.step": [(19, 100), (110, 190)],
    "train.preprocess": [(21, 31), (111, 121)],
    "train.forward": [(32, 60), (122, 150)],
    "train.backward": [(61, 85), (151, 175)],
    "train.optimizer": [(86, 99), (176, 189)],
    "eval.call": [(215, 260)], "audit.fetch": [(262, 270)],
    "audit.record": [(272, 295)]}) + [
    # the device's copies of the program's ranges, flagged as the card's
    # torch flags them
    Event("sia.train.step", CUDA, 19, 100, user=True),
    Event("sia.eval.call", CUDA, 215, 260, user=True)]
#: a copy the profiler left unflagged: no device operation either
UNFLAGGED = [Event("sia.train.forward", CUDA, 32, 60)]
# (launch at, device start, device end, name, launching thread): the
# backward's launches come from autograd's own thread
LAUNCHED = [(14, 14, 16, "Memcpy HtoD", 1),
            (23, 40, 50, "preprocess_cluster_kernel", 1),
            (35, 50, 70, "cutlass_fprop", 1),
            (40, 80, 90, "elementwise_kernel", 1),
            (65, 90, 110, "cudnn_wgrad", 2),
            (90, 110, 115, "adam_kernel", 1),
            (125, 125, 140, "cutlass_fprop", 1),
            (155, 140, 160, "cudnn_wgrad", 2),
            (180, 160, 170, "adam_kernel", 1),
            (255, 250, 255, "reduce_kernel", 1)]


def _launches():
    out = [Event("port_bench.train", CUDA, 10, 200)]
    for i, (t, a, b, name, thread) in enumerate(LAUNCHED, start=100):
        out.append(Event("cudaLaunchKernel", CPU, t, t + 1, corr=i,
                         thread=thread))
        out.append(Event(name, CUDA, a, b, corr=i))
    # one device operation tied to its operator, not to a runtime call
    out.append(Event("aten::mm", CPU, 230, 232, corr=900))
    out.append(Event("gemm_kernel", CUDA, 220, 240, corr=901, linked=900))
    return out


def _program():
    return program_spans.reduce_program(HARNESS + PROGRAM + UNFLAGGED
                                        + _launches())


def test_the_accepted_reduction_keeps_its_values_with_the_program_spans():
    """The numbers ``trace.reduce`` gives the same profile without the
    ``sia.`` events: the program's ranges are no device operations."""
    for events in (HARNESS + PROGRAM + _launches(), HARNESS + _launches()):
        t = trace.reduce(events, STEPS)
        assert t.window_s == pytest.approx(300e-9)
        assert t.busy_s == pytest.approx(137e-9)
        assert t.kernels == {"train": 9, "preprocess": 1, "audit": 2}
        assert t.device_s == pytest.approx(
            {"train": 112e-9, "preprocess": 10e-9, "audit": 25e-9})
        assert t.calls == {"shuffle": 1, "train": 1, "fetch": 1,
                           "audit": 1, "preprocess": 2}
        assert (t.operations, t.launches, t.steps) == (11, 11, STEPS)
        assert t.groups == pytest.approx({
            "elementwise and other": 27e-9, "preprocess kernel (port)": 10e-9,
            "convolution (cuDNN)": 75e-9, "matmul (cuBLAS)": 20e-9,
            "reductions": 5e-9})
        assert [n for n, _ in t.idle_gaps][:3] == [
            "train (all gaps)", "audit (all gaps)", "shuffle (all gaps)"]


def test_program_spans_get_their_kernels_time_and_idle_gaps():
    got = _program()
    want = {  # calls, host ns, kernels, device ns, idle ns
        "train.call": (1, 184, 9, 112, 94),
        "train.step": (2, 161, 8, 110, 44),
        "train.preprocess": (2, 20, 1, 10, 34),
        "train.forward": (2, 56, 3, 45, 0),
        "train.backward": (2, 48, 2, 40, 10),
        "train.optimizer": (2, 26, 2, 15, 0),
        "eval.call": (1, 45, 2, 25, 10),
        "audit.fetch": (1, 8, 0, 0, 0),
        "audit.record": (1, 23, 0, 0, 45)}
    assert got["audits"] == 1
    assert set(got["spans"]) == set(want)
    for span, (calls, host, kernels, device, idle) in want.items():
        row = got["spans"][span]
        assert (row["calls"], row["kernels"]) == (calls, kernels), span
        assert row["host_s"] == pytest.approx(host * 1e-9), span
        assert row["device_s"] == pytest.approx(device * 1e-9), span
        assert row["idle_s"] == pytest.approx(idle * 1e-9), span


def test_an_idle_gap_is_named_by_the_innermost_span_that_holds_it():
    got = _program()["idle_gaps"]
    assert len(got) == 10
    assert [name for name, _ in got] == [
        "train.call (all gaps)", "audit.record (all gaps)",
        "train.preprocess (all gaps)", "shuffle (all gaps)",
        "train.backward (all gaps)", "eval.call (all gaps)",
        "train.call (one gap)", "audit.record (one gap)",
        "train.preprocess (one gap)", "shuffle (one gap)"]
    assert [s for _, s in got] == pytest.approx(
        [x * 1e-9 for x in (50, 45, 34, 14, 10, 10, 50, 45, 24, 14)])
    # the idle time is the accepted reduction's
    t = trace.reduce(HARNESS + PROGRAM + _launches(), STEPS)
    total = sum(s for n, s in got if n.endswith("(all gaps)"))
    assert total == pytest.approx(t.window_s - t.busy_s)


def test_without_the_harness_epoch_there_is_nothing_to_reduce():
    assert program_spans.reduce_program(PROGRAM + _launches()) is None


PER_STEP = {"forward_device_ms": 45e-6 / STEPS,
            "backward_device_ms": 40e-6 / STEPS,
            "optimizer_device_ms": 15e-6 / STEPS,
            "step_idle_ms": 94e-6 / STEPS}
PER_AUDIT = {"audit_device_ms": 25e-6, "audit_record_ms": 23e-6}


@pytest.mark.parametrize("metric", [*PER_STEP, *PER_AUDIT])
def test_a_number_needs_the_trace_and_its_step_count(metric):
    want = {**PER_STEP, **PER_AUDIT}[metric]
    assert program_spans.numbers(_program(), STEPS)[metric] == \
        pytest.approx(want)
    assert program_spans.numbers(None, STEPS)[metric] is None
    bare = program_spans.reduce_program(HARNESS + _launches())
    assert program_spans.numbers(bare, STEPS)[metric] is None
    other = program_spans.numbers(_program(), STEPS + 1)[metric]
    if metric in PER_STEP:
        assert other is None
    else:
        assert other == pytest.approx(want)


SPANS = ("train.call", "train.preprocess", "train.forward",
         "train.backward", "train.optimizer", "eval.call", "audit.record")


# the transfer driver fetches the audit's outputs itself, as
# ``classify._evaluate`` does, so only the flagship's audit has a fetch span
@pytest.mark.parametrize("cell,spans", [
    ("flagship-isic-train", SPANS + ("audit.fetch",)),
    ("resnet50-ham-finetune", SPANS)])
def test_the_traced_epoch_holds_one_step_range_a_live_step(cell, spans):
    """The benchmark's traced epoch on the CPU: the program's spans are
    there, and ``train.step`` counts the epoch's live steps."""
    got = program_spans.report(tiny_spec(cell), 9, device="cpu")
    assert got["steps"] > 0
    assert got["spans"]["train.step"]["calls"] == got["steps"]
    for span in spans:
        assert got["spans"][span]["calls"] > 0, span
    assert all(v is not None for v in got["metrics"].values())

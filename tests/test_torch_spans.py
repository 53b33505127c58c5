"""The program's spans (``utils.profiling.annotate``): nothing without a
profiler, one range a layer under one, nested as the train step and the
audit run, and no effect on what they mark."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.ops.preprocess import (
    AugmentConfig,
    make_preprocess_fn,
)
from skin_image_analysis_tpu_torch.train import evaluate
from skin_image_analysis_tpu_torch.train.loop import super_batches
from skin_image_analysis_tpu_torch.train.state import create_train_state
from skin_image_analysis_tpu_torch.train.step import multi_train_step
from skin_image_analysis_tpu_torch.utils.profiling import (
    SPAN_PREFIX,
    annotate,
)
from tests.test_torch_pooling import one_torch_thread  # noqa: F401
from tests.test_torch_train import SMALL_MODEL

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TRAIN_SPANS = ("train.step", "train.preprocess", "train.forward",
               "train.backward", "train.optimizer")
ROWS, TEST_ROWS = 6, 10


def _state():
    return create_train_state(tconfig.ModelConfig(**SMALL_MODEL),
                              tconfig.OptimConfig(), 0, "cpu")


def _arena(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 3, 32, 32), dtype=torch.uint8,
                         generator=g)


def _train_call(state):
    """One call of two steps, the second inert."""
    pre = make_preprocess_fn(32, train=True, augment=AugmentConfig(),
                             layout="planar")
    idx = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    valid = np.array([[True, True, True], [False, False, False]])
    return multi_train_step(state, _arena(ROWS, 1), idx, idx % 2, valid,
                            preprocess_fn=pre)


def _audit(state):
    """The fairness record over a test arena of two calls of two
    batches."""
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 2, TEST_ROWS)
    codes = {g: rng.integers(-1, 2, TEST_ROWS)
             for g in ("skin_tone", "sex", "control")}
    batches = super_batches(np.arange(TEST_ROWS), labels, 4, 2,
                            drop_remainder=False, with_row_ids=True)
    pre = make_preprocess_fn(32, train=False, layout="planar")
    return evaluate.evaluate_fairness(state.model, _arena(TEST_ROWS, 3),
                                      batches, labels, codes, pre)


def _ranges(prof) -> dict[str, list[tuple[int, int]]]:
    """Host ranges of the profile's events by name, in start order."""
    out: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _spans(prof) -> dict[str, list[tuple[int, int]]]:
    return {k[len(SPAN_PREFIX):]: v for k, v in _ranges(prof).items()
            if k.startswith(SPAN_PREFIX)}


def _within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_the_off_path_creates_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with annotate("outside"):
        pass
    state = _state()
    assert _train_call(state)["count"].tolist() == [3, 0]
    assert "auc" in _audit(state)


def test_a_train_call_gives_one_range_a_layer_nested_in_its_parent():
    state = _state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train_call(state)
    spans, ranges = _spans(prof), _ranges(prof)
    assert len(spans["train.call"]) == 1
    for name in TRAIN_SPANS:
        assert len(spans[name]) == 1, name
    assert "train.reduce" not in spans
    [call], [step] = spans["train.call"], spans["train.step"]
    assert _within(step, call)
    for name in TRAIN_SPANS[1:]:
        assert _within(spans[name][0], step), name
    order = [spans[n][0] for n in TRAIN_SPANS[1:]]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    assert any(_within(r, spans["train.forward"][0])
               for r in ranges["aten::convolution"])
    assert any(_within(r, spans["train.optimizer"][0])
               for name, rs in ranges.items()
               if name.startswith("aten::sqrt") for r in rs)


def test_an_audit_gives_its_calls_then_the_fetch_then_the_record():
    state = _state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _audit(state)
    spans = _spans(prof)
    calls = spans["eval.call"]
    assert len(calls) == 2          # ten rows: two calls of two batches
    assert all(a[1] <= b[0] for a, b in zip(calls, calls[1:]))
    [fetch], [record] = spans["audit.fetch"], spans["audit.record"]
    assert calls[-1][1] <= fetch[0] and fetch[1] <= record[0]


def test_each_loader_batch_is_one_eval_call():
    state = _state()
    arena = _arena(TEST_ROWS, 3)
    batches = [{"pixels": arena[i:i + 4], "row_id": torch.arange(i, i + 4),
                "valid": torch.ones(4, dtype=torch.bool)}
               for i in range(0, 8, 4)]
    pre = make_preprocess_fn(32, train=False, layout="planar")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        evaluate.collect_predictions(state.model, None, batches, pre)
    calls = _spans(prof)["eval.call"]
    assert len(calls) == len(batches)
    assert all(a[1] <= b[0] for a, b in zip(calls, calls[1:]))


def _profiled(fn, on: bool):
    if not on:
        return fn()
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


@pytest.mark.parametrize("part", ["train", "audit"])
def test_the_profiler_changes_nothing_the_spans_mark(part):
    def run():
        state = _state()
        state.generator.manual_seed(7)
        m = _train_call(state)
        if part == "audit":
            return _audit(state)
        return m["loss"], [p.detach().clone()
                           for p in state.model.parameters()]

    off, on = _profiled(run, False), _profiled(run, True)
    if part == "audit":
        assert on == off
        return
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)

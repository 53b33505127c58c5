"""The port's profiling and NaN checks, the train CLI's ``--profile`` and
``--debug-nans``, the process monitor and the metadata and dataset CLIs
against the JAX package's, on the CPU."""

import contextlib
import functools
import io
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from skin_image_analysis_tpu.cli import tone_bias_dataset as jdataset_cli
from skin_image_analysis_tpu.cli import tone_bias_metadata as jmetadata_cli
from skin_image_analysis_tpu.cli import tone_bias_train as jtrain_cli
from skin_image_analysis_tpu.utils import monitor as jmonitor
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.cli import monitor_processes as tmonitor_cli
from skin_image_analysis_tpu_torch.cli import tone_bias_dataset as tdataset_cli
from skin_image_analysis_tpu_torch.cli import tone_bias_metadata as tmetadata_cli
from skin_image_analysis_tpu_torch.cli import tone_bias_train as ttrain_cli
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from skin_image_analysis_tpu_torch.train.state import create_train_state
from skin_image_analysis_tpu_torch.train.step import (
    debug_nans,
    multi_eval_step,
    multi_train_step,
)
from skin_image_analysis_tpu_torch.utils import monitor as tmonitor
from skin_image_analysis_tpu_torch.utils.profiling import Timer, annotate, trace
from tests.fixtures import make_synthetic_dataset
from tests.test_torch_cli import _jax_one_device
from tests.test_torch_pooling import one_torch_thread  # noqa: F401
from tests.test_torch_train import SMALL_MODEL


pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--batch-size", "4", "--steps-per-dispatch", "2", "--image-size",
        "32"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort32"))
    make_synthetic_dataset(root, n=72, seed=11, image_size=32)
    return root


def test_timer_measures_the_block():
    with Timer("x") as t:
        sum(range(10000))
    assert t.name == "x" and 0.0 < t.elapsed < 5.0


def _events(path) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with trace(str(tmp_path / "prof")) as path:
        with annotate("outer_span"):
            with annotate("inner_span"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(path) == str(tmp_path / "prof")
    names = [e.get("name", "") for e in _events(path)]
    assert "sia.outer_span" in names and "sia.inner_span" in names
    assert any(n.startswith("aten::mm") for n in names)


def test_train_cli_profile_writes_the_run_trace(cohort, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert ttrain_cli.main([cohort, "1", "balance", *ARGS, "--profile",
                            "prof", "--device", "cpu"]) == 0
    [name] = os.listdir(tmp_path / "prof")
    names = {e.get("name", "") for e in _events(tmp_path / "prof" / name)}
    assert {"aten::convolution", "aten::max_pool2d_with_indices"} & names
    assert {"sia.epoch", "sia.train.step"} <= names
    [folder] = os.listdir(tmp_path / "results")
    assert os.path.exists(tmp_path / "results" / folder
                          / tckpt.MODEL_FILENAME)


# -- debug_nans --------------------------------------------------------------

def _state(lr=1e-3, optimizer="sgd"):
    state = create_train_state(
        tconfig.ModelConfig(**{**SMALL_MODEL, "image_size": 16}),
        tconfig.OptimConfig(learning_rate=lr, optimizer=optimizer), 0,
        "cpu")
    rng = np.random.default_rng(0)
    arena = torch.from_numpy(rng.uniform(0, 1, (8, 16, 16, 3)).astype(
        np.float32))
    idx = np.arange(8, dtype=np.int32).reshape(2, 4)
    labels = np.array([[0, 1, 0, 1], [1, 0, 1, 0]], np.int32)
    return state, arena, idx, labels, np.ones((2, 4), bool)


def test_debug_nans_names_the_step_inside_a_multi_step_call():
    """An infinite learning rate leaves step 1 finite and makes step 2's
    weights NaN: the check names step 2 of the call."""
    state, arena, idx, labels, valid = _state(lr=float("inf"))
    m = multi_train_step(state, arena, idx[:1], labels[:1], valid[:1])
    assert torch.isfinite(m["loss"]).all()  # unchecked, step 1 is finite
    state, arena, idx, labels, valid = _state(lr=float("inf"))
    with debug_nans(), pytest.raises(FloatingPointError,
                                     match="train step 2"):
        multi_train_step(state, arena, idx, labels, valid)


def test_debug_nans_names_the_gradient():
    """A finite forward whose backward gives an infinite gradient, which
    anomaly mode does not flag (it looks for NaN): the check after the
    backward names the parameter."""
    state, arena, idx, labels, valid = _state()
    state.model.head.weight.register_hook(
        lambda g: torch.full_like(g, float("inf")))
    with debug_nans(), pytest.raises(
            FloatingPointError,
            match="non-finite gradient of head.weight in train step 1"):
        multi_train_step(state, arena, idx[:1], labels[:1], valid[:1])
    assert not torch.is_anomaly_enabled()


class _NaNBackward(torch.autograd.Function):
    """The identity, whose backward returns NaN."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def test_debug_nans_raises_anomaly_modes_nan_as_floating_point_error():
    """A finite forward through a function whose backward returns NaN:
    anomaly mode's RuntimeError comes out as FloatingPointError naming
    the step and the function."""
    state, arena, idx, labels, valid = _state()
    state.model.head.register_forward_hook(
        lambda module, args, out: _NaNBackward.apply(out))
    with debug_nans(), pytest.raises(
            FloatingPointError,
            match="train step 1: Function '_NaNBackwardBackward' returned "
                  "nan values") as err:
        multi_train_step(state, arena, idx[:1], labels[:1], valid[:1])
    assert isinstance(err.value.__cause__, RuntimeError)
    assert not torch.is_anomaly_enabled()


def test_debug_nans_checks_the_eval_pass_and_restores_anomaly_mode():
    state, arena, idx, labels, valid = _state()
    assert not torch.is_anomaly_enabled()
    with debug_nans():
        assert torch.is_anomaly_enabled()
        out = multi_eval_step(state.model, arena, idx, idx, valid)
        assert torch.isfinite(out["log_probs"]).all()
        with torch.no_grad():
            state.model.head.bias[1] = float("nan")
        with pytest.raises(FloatingPointError, match="log-probs in an eval"):
            multi_eval_step(state.model, arena, idx, idx, valid)
    assert not torch.is_anomaly_enabled()
    multi_eval_step(state.model, arena, idx, idx, valid)  # unchecked


def _nan_init(tmp_path, nan: bool) -> str:
    cfg = tconfig.ModelConfig(**SMALL_MODEL)
    state = create_train_state(cfg, tconfig.OptimConfig(), 3, "cpu")
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    if nan:
        sd["conv_blocks.0.weight"][0, 0, 0, 0] = float("nan")
    path = str(tmp_path / f"init_{nan}.msgpack")
    tckpt.save_model(path, cfg, sd)
    return path


@contextlib.contextmanager
def _jax_debug_nans_reset():
    """The JAX CLI turns jax_debug_nans on for the process; off after."""
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("nan", [True, False])
def test_debug_nans_cli_matches_jax(cohort, tmp_path, monkeypatch, nan):
    """With one NaN in the first conv weight both packages' train CLIs
    raise FloatingPointError under --debug-nans (the port's at train step
    1's log-probs, its first check that the NaN reaches); without it both
    finish."""
    monkeypatch.chdir(tmp_path)
    init = _nan_init(tmp_path, nan)
    argv = [cohort, "1", "balance", *ARGS, "--init-from", init,
            "--debug-nans"]
    with _jax_one_device(), _jax_debug_nans_reset():
        if nan:
            with pytest.raises(FloatingPointError):
                jtrain_cli.main(argv)
        else:
            assert jtrain_cli.main(argv) == 0
    if nan:
        with pytest.raises(FloatingPointError,
                           match="non-finite log-probs in train step 1"):
            ttrain_cli.main([*argv, "--device", "cpu"])
    else:
        assert ttrain_cli.main([*argv, "--device", "cpu"]) == 0
    assert not torch.is_anomaly_enabled()


# -- the metadata and dataset CLIs, the monitor ------------------------------

def _stdout(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_metadata_cli_prints_what_jax_prints(cohort):
    path = os.path.join(cohort, "metadata.csv")
    got, want = (_stdout(m, [path]) for m in (tmetadata_cli.main,
                                              jmetadata_cli.main))
    assert got == want and got[0] == 0
    assert "Skin-type x diagnosis grid:" in got[1]
    assert _stdout(tmetadata_cli.main, []) == _stdout(jmetadata_cli.main,
                                                      [])


def _counts(text: str) -> list[str]:
    """The dataset CLI's lines but its timings."""
    return [line.split(" in ")[0] for line in text.splitlines()
            if line.startswith(("decoded", "iterated"))]


@pytest.mark.parametrize("mode", ["balance", "imbalanced"])
def test_dataset_cli_counts_match_jax(cohort, tmp_path, monkeypatch, mode):
    """Both CLIs draw unseeded, as the reference's does: the test seeds
    each one's ingest calls alike."""
    for cli in (tdataset_cli, jdataset_cli):
        for name in ("read_isic_metadata", "balance_dataset",
                     "shuffle_split"):
            monkeypatch.setattr(cli, name, functools.partial(
                getattr(cli, name), seed=0))
    roots = {}
    for who in ("port", "jax"):
        roots[who] = str(tmp_path / who)
        shutil.copytree(cohort, roots[who])
    rc, got = _stdout(tdataset_cli.main, [roots["port"], mode, "--device",
                                          "cpu"])
    assert rc == 0
    with _jax_one_device():
        rc, want = _stdout(jdataset_cli.main, [roots["jax"], mode])
    assert rc == 0
    assert _counts(got) == _counts(want) and len(_counts(got)) == 2
    written = [os.path.exists(os.path.join(r, "balanced_metadata.csv"))
               for r in roots.values()]
    assert written == [mode == "balance"] * 2
    if mode == "balance":
        mine, theirs = (pd.read_csv(os.path.join(roots[w],
                                                 "balanced_metadata.csv"))
                        for w in ("port", "jax"))
        pd.testing.assert_frame_equal(mine, theirs)


def test_monitor_records_have_the_jax_keys(capsys):
    mine, theirs = (m.print_python_processes(verbose=True)
                    for m in (tmonitor, jmonitor))
    me = [r for r in mine if r["pid"] == os.getpid()]
    assert len(me) == 1 and "error" not in me[0]
    want = [r for r in theirs if r["pid"] == os.getpid()][0]
    assert set(me[0]) == set(want)
    assert tmonitor.fd_count() > 0
    assert tmonitor_cli.main(["--verbose"]) == 0
    assert f"pid={os.getpid()} " in capsys.readouterr().out


def test_monitor_reports_an_unparsable_fd_table(monkeypatch):
    """psutil's fdinfo parser raises IndexError on a kernel whose fdinfo
    lacks the flags line: the record holds open_files None, the line a
    "?", and the other figures."""
    import psutil

    def broken(self):
        raise IndexError("list index out of range")

    monkeypatch.setattr(psutil.Process, "open_files", broken)
    [me] = [r for r in tmonitor.print_python_processes()
            if r["pid"] == os.getpid()]
    assert me["open_files"] is None and me["num_fds"] > 0


def test_monitor_without_psutil_names_it(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "psutil", None)
    with pytest.raises(ImportError, match="psutil"):
        tmonitor.fd_count()

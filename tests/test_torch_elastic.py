"""Elastic crash recovery of the port (``run_training_elastic`` and the
``SIA_FAULT_ONCE`` hook), on the CPU: the port's counterparts of
``tests/test_elastic.py``, one run of each package's supervisor through
the same injected fault (progress markers, epoch records and per-step
losses to rtol 1e-4), and the train CLI's ``--auto-resume``."""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest

from skin_image_analysis_tpu.train import loop as jloop
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.cli import tone_bias_train as ttrain_cli
from skin_image_analysis_tpu_torch.train import loop as tloop
from skin_image_analysis_tpu_torch.train.loop import (
    completed_epochs,
    run_training_elastic,
)
from tests.test_torch_cli import _records
from tests.test_torch_optim import check_paired, cohort, paired_runs  # noqa: F401
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tiny_cfg(root, tmp_path, epochs=1, **data_kw):
    data = dict(root_dir=root, image_size=32, canonical_size=40,
                batch_size=8, balance=False, decode_workers=2,
                prefetch_depth=1, seed=0)
    data.update(data_kw)
    return tconfig.TrainConfig(
        epochs=epochs, results_dir=str(tmp_path / "results"),
        log_every_batches=0, seed=0,
        data=tconfig.DataConfig(**data),
        model=tconfig.ModelConfig(conv_features=(8, 16),
                                  linear_features=(16,), dropout=(0.2,),
                                  image_size=32, compute_dtype="float32"),
        optim=tconfig.OptimConfig(learning_rate=1e-3))


def _elastic(cfg, retries):
    return run_training_elastic(cfg, retries=retries, verbose=False,
                                device="cpu")


def _markers(folder):
    with open(os.path.join(folder, "epochs_completed.log")) as f:
        return [int(ln) for ln in f if ln.strip()]


@pytest.fixture()
def fault(tmp_path, monkeypatch):
    path = tmp_path / "fault"
    path.write_text("")
    monkeypatch.setenv("SIA_FAULT_ONCE", str(path))
    return path


def test_elastic_resumes_after_injected_fault(cohort, tmp_path, fault):
    """A run that crashes after its first epoch is found, resumed for the
    remaining epochs, and ends with the full epoch count."""
    cfg = dataclasses.replace(_tiny_cfg(cohort, tmp_path, epochs=3),
                              checkpoint_every=1)
    folder = _elastic(cfg, 2)
    assert not fault.exists()
    assert completed_epochs(folder) == 3
    names = os.listdir(folder)
    assert "session_model.msgpack" in names
    assert "session_train.csv" in names


def test_elastic_counts_epochs_without_fairness_records(cohort, tmp_path,
                                                        fault):
    """The epoch count comes from the progress markers, not the records:
    with eval_every=2 only half the epochs have records."""
    cfg = dataclasses.replace(_tiny_cfg(cohort, tmp_path, epochs=4),
                              checkpoint_every=1, eval_every=2)
    folder = _elastic(cfg, 2)
    assert completed_epochs(folder) == 4
    values = _markers(folder)
    assert values[-1] == 4
    assert values == sorted(values)


def test_elastic_gives_up_when_retries_exhausted(cohort, tmp_path, fault):
    cfg = dataclasses.replace(_tiny_cfg(cohort, tmp_path, epochs=2),
                              checkpoint_every=1)
    with pytest.raises(RuntimeError, match="injected fault"):
        _elastic(cfg, 0)


def test_elastic_without_snapshots_retrains_in_full(cohort, tmp_path,
                                                    fault):
    """checkpoint_every=0: the crashed run's epochs were never saved, so
    the retry trains them all again."""
    folder = _elastic(_tiny_cfg(cohort, tmp_path, epochs=2), 1)
    assert completed_epochs(folder) == 2
    assert _markers(folder) == [2]


def test_elastic_abandons_broken_experiment_dir(cohort, tmp_path):
    """A target folder without split CSVs can never resume: the
    supervisor runs fresh instead."""
    broken = tmp_path / "results" / "imbalanced_broken"
    broken.mkdir(parents=True)
    cfg = dataclasses.replace(_tiny_cfg(cohort, tmp_path, epochs=1),
                              experiment_dir=str(broken))
    folder = _elastic(cfg, 1)
    assert folder != str(broken)
    assert completed_epochs(folder) == 1


def test_elastic_finds_folder_when_name_overrides_balance(cohort, tmp_path,
                                                          fault):
    """A new experiment_dir named 'imbalanced_*' overrides
    cfg.data.balance: the supervisor watches the prefix run_training
    used, and resumes the crashed run instead of restarting it."""
    cfg = dataclasses.replace(
        _tiny_cfg(cohort, tmp_path, epochs=2, balance=True),
        checkpoint_every=1,
        experiment_dir=str(tmp_path / "results" / "imbalanced_target"))
    folder = _elastic(cfg, 1)
    assert not fault.exists()
    assert completed_epochs(folder) == 2
    assert os.path.basename(folder).startswith("imbalanced_")
    results = str(tmp_path / "results")
    made = [d for d in os.listdir(results) if d.startswith("imbalanced_")]
    assert len(made) == 1
    assert _markers(folder) == [1, 2, 2]


def test_elastic_resume_matches_plain_semantics(cohort, tmp_path):
    """An existing folder gets cfg.epochs more epochs, as a plain resume
    does."""
    cfg = _tiny_cfg(cohort, tmp_path, epochs=2)
    folder = _elastic(cfg, 0)
    assert completed_epochs(folder) == 2
    resumed = _elastic(dataclasses.replace(cfg, experiment_dir=folder), 0)
    assert resumed == folder
    assert completed_epochs(folder) == 4


def test_elastic_crash_on_resumed_folder_trains_only_remainder(
        cohort, tmp_path, monkeypatch):
    """A crash while resuming re-trains only the unsaved remainder of
    this call's epochs."""
    cfg = dataclasses.replace(_tiny_cfg(cohort, tmp_path, epochs=1),
                              checkpoint_every=1)
    folder = _elastic(cfg, 0)
    assert completed_epochs(folder) == 1
    fault = tmp_path / "fault_resume"
    fault.write_text("")
    monkeypatch.setenv("SIA_FAULT_ONCE", str(fault))
    resumed = _elastic(dataclasses.replace(cfg, epochs=2,
                                           experiment_dir=folder), 2)
    assert resumed == folder
    assert not fault.exists()
    assert completed_epochs(folder) == 3


def test_elastic_matches_jax_through_one_fault(cohort, tmp_path,
                                               monkeypatch):
    """Each package's supervisor through the same injected fault after
    epoch 1 of 3: the same progress markers, as many epoch records, the
    same records and per-step losses (the crashed attempt's, then the
    resumed one's) to rtol 1e-4."""
    fault = tmp_path / "fault"
    monkeypatch.setenv("SIA_FAULT_ONCE", str(fault))

    def run(loop, cfg):
        fault.write_text("")
        kw = {"device": "cpu"} if loop is tloop else {}
        folder = loop.run_training_elastic(cfg, retries=1, verbose=False,
                                           **kw)
        assert not fault.exists()
        return folder

    runs = paired_runs(tmp_path, cohort, epochs=3, run=run,
                       checkpoint_every=1)
    assert _markers(runs["port"]) == _markers(runs["jax"]) == [1, 2, 3, 3]
    assert len(_records(runs["port"])) == len(_records(runs["jax"])) == 3
    check_paired(runs)
    assert jloop.completed_epochs(runs["jax"]) == 3


def test_train_cli_auto_resume(cohort, tmp_path, fault):
    """``--auto-resume 1`` snapshots every epoch and resumes the crashed
    folder to its full count."""
    work = tmp_path / "work"
    work.mkdir()
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.chdir(work)
        assert ttrain_cli.main([cohort, "2", "imbalanced", "--batch-size",
                                "8", "--image-size", "32", "--fp32",
                                "--device", "cpu", "--auto-resume",
                                "1"]) == 0
    assert "auto-resume: restart 1/1" in out.getvalue()
    folder = out.getvalue().rsplit("Experiment folder: ", 1)[1].strip()
    folder = os.path.join(work, folder)
    assert not fault.exists()
    assert _markers(folder) == [1, 2, 2]
    assert len(_records(folder)) == 2
    assert np.isfinite([r["avg_batch_loss"] for r in _records(folder)]).all()

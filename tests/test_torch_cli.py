"""The port's experiment driver and CLIs against the JAX package's, on the
CPU: one whole run of each package from the same JAX-written artifact
(the same splits, per-step losses to rtol 1e-4, equal records with AUCs
to 1e-6, the same keep-best and early-stop epochs), the port's test CLI
on a JAX-trained folder, the port's counterparts of
``tests/test_e2e_train.py`` (streaming and the mesh left out), and both
CLIs on a DICOM cohort with jax, the JAX package, pandas, PIL, cv2 and
msgpack unimportable."""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu.cli import tone_bias_test as jtest_cli
from skin_image_analysis_tpu.train import checkpoint as jckpt
from skin_image_analysis_tpu.train import loop as jloop
from skin_image_analysis_tpu.train import state as jstate
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.cli import tone_bias_predict as tpredict_cli
from skin_image_analysis_tpu_torch.cli import tone_bias_test as ttest_cli
from skin_image_analysis_tpu_torch.cli import tone_bias_train as ttrain_cli
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from skin_image_analysis_tpu_torch.train import loop as tloop
from skin_image_analysis_tpu_torch.utils import jsonl
from tests.fixtures import make_synthetic_dataset
from tests.test_torch_data import write_dicom_cohort
from tests.test_torch_native_loader import same_decoders
from tests.test_torch_train import SMALL_MODEL, _check_record
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")

DI_KEYS_SUBSET = {"accuracy", "di", "selection_rate_min",
                  "selection_rate_maj", "tp_min", "tn_maj", "f1"}
TIMES = ("epoch_time_s", "eval_time_s")


@contextlib.contextmanager
def _jax_one_device():
    """The JAX package on one CPU device; both packages decode through
    their libjpeg decoders, which give the same bytes."""
    with pytest.MonkeyPatch.context() as mp:
        devices = jax.devices()
        mp.setattr(jax, "devices", lambda *a: devices[:1])
        same_decoders(mp)
        yield mp


def _records(folder):
    names = sorted(n for n in os.listdir(folder)
                   if n.endswith(".json") and n[0].isdigit())
    return [r for n in names
            for r in jsonl.read_records(os.path.join(folder, n))]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort32"))
    make_synthetic_dataset(root, n=72, seed=11, image_size=32)
    return root


@pytest.fixture(scope="module")
def runs(cohort, tmp_path_factory):
    """One run of each package from the same JAX-written artifact: dropout
    0, no augment, keep-best on accuracy, early stop, a snapshot each
    epoch; per-step losses recorded at the multi-step calls."""
    tmp = tmp_path_factory.mktemp("runs")
    jcfg_model = jconfig.ModelConfig(**SMALL_MODEL)
    state, _ = jstate.create_train_state(jcfg_model, jconfig.OptimConfig(),
                                         jax.random.key(0))
    artifact = str(tmp / "init.msgpack")
    jckpt.save_model(artifact, jcfg_model, state.params)
    jcfg = jconfig.TrainConfig(
        epochs=8, results_dir=str(tmp / "jax"), init_from=artifact,
        checkpoint_every=1, checkpoint_best=True, best_metric="accuracy",
        early_stop_patience=2, log_every_batches=0, seed=0,
        data=jconfig.DataConfig(
            root_dir=cohort, image_size=32, canonical_size=32, batch_size=4,
            decode_workers=2, prefetch_depth=1, seed=0,
            steps_per_dispatch=2),
        optim=jconfig.OptimConfig(learning_rate=3e-3))
    tcfg = tconfig.train_config_from_dict(json.loads(jconfig.to_json(jcfg)))
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp / "port"))

    jax_losses, port_losses = [], []
    with _jax_one_device() as mp:
        make_multi = jloop.make_multi_train_step

        def recording_multi(*a, **kw):
            multi = make_multi(*a, **kw)

            def call(*args):
                state, m = multi(*args)
                m = jax.device_get(m)
                if m["count"].any():  # not the inert warm-up call
                    jax_losses.append(np.asarray(m["loss"]))
                return state, m
            return call

        mp.setattr(jloop, "make_multi_train_step", recording_multi)
        jax_folder = jloop.run_training(jcfg, verbose=False)

        multi_step = tloop.multi_train_step

        def recording_step(*a, **kw):
            m = multi_step(*a, **kw)
            port_losses.append(m["loss"].numpy())
            return m

        mp.setattr(tloop, "multi_train_step", recording_step)
        port_folder = tloop.run_training(tcfg, verbose=False, device="cpu")
    return dict(cohort=cohort, jax=jax_folder, port=port_folder,
                jax_losses=jax_losses, port_losses=port_losses, cfg=tcfg)


def test_whole_run_matches_jax(runs):
    """The same split files, per-step losses to rtol 1e-4, the records
    (counts, accuracy and DI exact, AUCs to 1e-6, the average loss to
    rtol 1e-4), early stop at the same epoch, and a best model saved at
    the same epoch."""
    for name in ("session_train.csv", "session_test.csv"):
        want = pd.read_csv(os.path.join(runs["jax"], name), index_col=0)
        got = pd.read_csv(os.path.join(runs["port"], name), index_col=0)
        assert list(got["isic_id"]) == list(want["isic_id"])
        pd.testing.assert_frame_equal(got, want)
    assert len(runs["port_losses"]) == len(runs["jax_losses"])
    for got, want in zip(runs["port_losses"], runs["jax_losses"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)

    done = tloop.completed_epochs(runs["port"])
    assert done == jloop.completed_epochs(runs["jax"])
    assert done < runs["cfg"].epochs  # early stop fired
    mine, theirs = _records(runs["port"]), _records(runs["jax"])
    assert len(mine) == len(theirs) == done
    for got, want in zip(mine, theirs):
        assert set(got) == set(want) == set(tloop.RECORD_KEYS)
        _check_record(
            {k: v for k, v in got.items() if k not in TIMES},
            {k: v for k, v in want.items()
             if k not in TIMES and k != "avg_batch_loss"},
            lambda k: 1e-6 if k.startswith("auc") else 0.0)
        assert got["avg_batch_loss"] == pytest.approx(
            want["avg_batch_loss"], rel=1e-4)
    accs = [r["accuracy"] for r in mine]
    assert accs.index(max(accs)) < done - 1  # the best is not the last

    # the best models hold the same epoch's weights: closer to each other
    # than to either package's final weights
    def weights(path):
        _, sd = tckpt.load_model(path)
        return torch.cat([v.flatten() for v in sd.values()])

    best = [weights(os.path.join(runs[p], tckpt.BEST_MODEL_FILENAME))
            for p in ("port", "jax")]
    final = weights(os.path.join(runs["port"], tckpt.MODEL_FILENAME))
    assert (best[0] - best[1]).norm() < 0.1 * (best[0] - final).norm()


def _cli_record(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    text = out.getvalue()
    return json.loads(text[text.index("{"):text.rindex("}") + 1])


@pytest.mark.parametrize("best", [False, True], ids=["final", "best"])
def test_test_cli_on_a_jax_folder_matches_jax(runs, best):
    """The port's test CLI on the JAX-trained folder gives the JAX test
    CLI's record: counts, accuracy and DI exact, AUCs to 1e-6."""
    flags = ["--best"] if best else []
    with _jax_one_device():
        want = _cli_record(jtest_cli.main,
                           [runs["cohort"], runs["jax"], *flags])
    got = _cli_record(ttest_cli.main, [runs["cohort"], runs["jax"],
                                       "--device", "cpu", *flags])
    assert got["total"] == len(pd.read_csv(
        os.path.join(runs["jax"], "session_test.csv")))
    assert set(got) == set(want)
    _check_record(got, want, lambda k: 1e-6 if k.startswith("auc") else 0.0)


def test_keep_best_model_scores_the_best_epoch(runs):
    """The canonical frames are the model's size, so the test CLI scores
    exactly what each epoch's eval scored: the best model the best
    epoch's accuracy, the final model the last epoch's."""
    accs = [r["accuracy"] for r in _records(runs["port"])]
    for flags, want in (([], accs[-1]), (["--best"], max(accs))):
        got = _cli_record(ttest_cli.main, [runs["cohort"], runs["port"],
                                           "--device", "cpu", *flags])
        assert got["accuracy"] == want


def test_resume_refuses_a_jax_folder(runs):
    """A JAX-made folder holds an orbax snapshot: the port refuses to
    resume it instead of restarting from the model file."""
    cfg = dataclasses.replace(runs["cfg"], epochs=1,
                              experiment_dir=runs["jax"])
    with pytest.raises(ValueError, match="orbax"):
        tloop.run_training(cfg, verbose=False, device="cpu")


TRAIN_ARGS = ["--batch-size", "8", "--image-size", "32",
              "--steps-per-dispatch", "2", "--device", "cpu", "--fp32",
              "--checkpoint-every", "1"]


@pytest.fixture(scope="module")
def trained(cohort, tmp_path_factory):
    """Two epochs of an imbalanced run through the train CLI, in a
    working directory of its own (new runs go under ./results)."""
    work = tmp_path_factory.mktemp("cli")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert ttrain_cli.main([cohort, "2", "imbalanced",
                                    *TRAIN_ARGS]) == 0
    folder = out.getvalue().rsplit("Experiment folder: ", 1)[1].strip()
    return os.path.join(work, folder)


def test_experiment_layout(trained):
    names = set(os.listdir(trained))
    assert {"session_train.csv", "session_test.csv", "train_config.json",
            "session_model.msgpack", "checkpoint",
            "epochs_completed.log"} <= names
    assert os.listdir(os.path.join(trained, "checkpoint")) == [
        tckpt.STATE_FILENAME]
    assert any(n.endswith(".json") and n[0].isdigit() for n in names)
    assert os.path.basename(trained).startswith("imbalanced_")
    # --checkpoint-every 1: a marker after each epoch's snapshot, then the
    # final save's
    assert open(os.path.join(trained, "epochs_completed.log")).read() \
        == "1\n2\n2\n"
    assert os.path.dirname(trained).endswith("results")
    cfg = tconfig.train_config_from_dict(json.load(open(
        os.path.join(trained, "train_config.json"))))
    assert cfg.data.canonical_size == 256 and not cfg.data.balance


def test_epoch_records_schema(trained):
    records = _records(trained)
    assert [r["epoch"] for r in records] == [0, 1]
    for rec in records:
        assert set(rec) == set(tloop.RECORD_KEYS)
        assert DI_KEYS_SUBSET <= set(rec["tone_di_results"])
        assert rec["total"] == rec["dark"] + rec["light"]
        assert np.isfinite(rec["avg_batch_loss"])


def test_resume_appends_new_results_file(trained, cohort, tmp_path,
                                         monkeypatch):
    """Resume: the frozen splits, a new results file, the snapshot
    restored bit for bit, the progress marker counting on."""
    import shutil

    folder = str(tmp_path / "copy")
    shutil.copytree(trained, folder)
    before = set(os.listdir(folder))
    saved = tckpt.read_train_state(os.path.join(folder, "checkpoint"))
    restored = []
    restore = tckpt.restore_train_state

    def recording_restore(ckpt_dir, template):
        restored.append(tckpt.snapshot(restore(ckpt_dir, template)))
        return template

    monkeypatch.setattr(tckpt, "restore_train_state", recording_restore)
    first = tloop._timestamp()
    while tloop._timestamp() == first:  # a results file of its own
        pass
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        assert ttrain_cli.main([cohort, "1", folder, *TRAIN_ARGS]) == 0
    new = set(os.listdir(folder)) - before
    assert len(new) == 1 and new.pop().endswith(".json")
    assert not os.path.exists(tmp_path / "results")
    [snap] = restored
    assert snap["step"] == saved["step"] > 0
    assert snap["opt_count"] == saved["opt_count"]
    assert torch.equal(snap["generator"], saved["generator"])
    for k in saved["model"]:
        assert torch.equal(snap["model"][k], saved["model"][k]), k
    for a, b in zip(snap["opt_state"]["mu"] + snap["opt_state"]["nu"],
                    saved["opt_state"]["mu"] + saved["opt_state"]["nu"]):
        assert torch.equal(a, b)
    assert tloop.completed_epochs(folder) == 3
    assert [r["epoch"] for r in _records(folder)] == [0, 1, 0]
    for name in ("session_train.csv", "session_test.csv"):
        assert open(os.path.join(folder, name)).read() == open(
            os.path.join(trained, name)).read()


def _small_cfg(cohort, tmp_path, **kw):
    return tconfig.TrainConfig(
        epochs=1, results_dir=str(tmp_path / "results"), seed=0,
        data=tconfig.DataConfig(root_dir=cohort, image_size=32,
                                canonical_size=32, batch_size=8,
                                balance=False, decode_workers=2,
                                steps_per_dispatch=2),
        model=tconfig.ModelConfig(conv_features=(8, 16),
                                  linear_features=(16,), dropout=(0.2,),
                                  image_size=32, compute_dtype="float32"),
        optim=tconfig.OptimConfig(learning_rate=1e-3), **kw)


@pytest.mark.parametrize("mode,prefix", [
    (None, "imbalanced_"), ("balance", "balanced_"),
    ("imbalanced_run", "imbalanced_"),
])
def test_run_folder_names(cohort, tmp_path, mode, prefix):
    cfg = _small_cfg(cohort, tmp_path, experiment_dir=mode)
    folder, is_resume, balance = tloop.resolve_experiment_folder(cfg)
    assert not is_resume and balance == (prefix == "balanced_")
    assert os.path.dirname(folder) == cfg.results_dir
    assert os.path.basename(folder).startswith(prefix)


def test_seeded_runs_reproduce(cohort, tmp_path):
    def run(sub):
        cfg = _small_cfg(cohort, tmp_path / sub)
        folder = tloop.run_training(cfg, verbose=False, device="cpu")
        recs = _records(folder)
        for r in recs:
            for k in TIMES:
                r.pop(k)
        return recs, open(os.path.join(folder, "session_test.csv")).read()

    assert run("a") == run("b")


def test_resume_without_model_file_restores_the_snapshot(cohort, tmp_path):
    """A crash after a periodic snapshot but before the model file: the
    resume restores the snapshot, and a resume of a folder with neither
    starts from fresh weights on the kept splits."""
    cfg = _small_cfg(cohort, tmp_path, checkpoint_every=1)
    folder = tloop.run_training(cfg, verbose=False, device="cpu")
    os.remove(os.path.join(folder, tckpt.MODEL_FILENAME))
    saved = tckpt.read_train_state(os.path.join(folder, "checkpoint"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tloop.run_training(dataclasses.replace(cfg, experiment_dir=folder),
                           device="cpu")
    assert "restored the snapshot" in out.getvalue()
    now = tckpt.read_train_state(os.path.join(folder, "checkpoint"))
    assert now["step"] == 2 * saved["step"]
    import shutil

    shutil.rmtree(os.path.join(folder, "checkpoint"))
    os.remove(os.path.join(folder, tckpt.MODEL_FILENAME))
    with contextlib.redirect_stdout(out):
        tloop.run_training(dataclasses.replace(cfg, experiment_dir=folder),
                           device="cpu")
    assert "initial weights, kept splits" in out.getvalue()


def test_resume_follows_artifact_image_size(trained, cohort, tmp_path):
    """An artifact trained at 32 wins over a data config asking for 16."""
    import shutil

    folder = str(tmp_path / "copy")
    shutil.copytree(trained, folder)
    cfg = _small_cfg(cohort, tmp_path, experiment_dir=folder)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, image_size=16, canonical_size=256))
    assert tloop.run_training(cfg, verbose=False, device="cpu") == folder
    assert len(_records(folder)) == 3


def test_auto_class_weights_run(cohort, tmp_path):
    cfg = _small_cfg(cohort, tmp_path)
    cfg = dataclasses.replace(cfg, optim=tconfig.OptimConfig(
        learning_rate=1e-3, auto_class_weights=True))
    folder = tloop.run_training(cfg, verbose=False, device="cpu")
    assert os.path.exists(os.path.join(folder, tckpt.MODEL_FILENAME))


@pytest.mark.parametrize("flags", [
    ["--streaming"], ["--streaming", "--stream-cache"],
], ids=["flag0-item 12", "flag1-item 12"])
def test_train_cli_refuses_unported_flags(cohort, tmp_path, monkeypatch,
                                          flags):
    """The streaming flags (once refused until ROADMAP item 12) stream the
    run in chunks; ``--stream-cache`` keeps the decoded frames in the
    folder under the JAX package's file names."""
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ttrain_cli.main([cohort, "1", "balance", *TRAIN_ARGS,
                                "--chunk-size", "16", *flags]) == 0
    text = out.getvalue()
    folder = text.rsplit("Experiment folder: ", 1)[1].strip()
    assert "streaming ingest: chunks of 16" in text
    assert "stream: decoded" in text
    caches = sorted(n for n in os.listdir(folder)
                    if n.startswith("stream_cache_"))
    want = [f"stream_cache_{split}_256.npy{ext}"
            for split in ("test", "train") for ext in ("", ".bad", ".ready")]
    assert caches == (want if "--stream-cache" in flags else [])
    [record] = _records(folder)
    assert record["total"] == len(pd.read_csv(
        os.path.join(folder, tloop.TEST_SET_FILENAME)))


@pytest.mark.parametrize("change,item", [
    (dict(data=dict(streaming=True, chunk_size=16)), "item 12"),
    (dict(mesh=dict(model_parallel=2)), "item 12"),
])
def test_run_training_refuses_unported_options(cohort, tmp_path, change,
                                               item):
    """The options once refused until ROADMAP item 12 run. Streaming
    trains the same steps as the decoded arenas (the chunks are the
    epoch's order cut in pieces, each batch's rows gathered by the
    preprocess kernel's twin from its chunk), so the weights and records
    match; a model-parallel mesh in one process without a process group
    is a single-device run, as the JAX package's is on one device."""
    base = _small_cfg(cohort, tmp_path / "base")
    cfg = _small_cfg(cohort, tmp_path)
    for sub, kw in change.items():
        cfg = dataclasses.replace(
            cfg, **{sub: dataclasses.replace(getattr(cfg, sub), **kw)})
    folders = [tloop.run_training(c, verbose=False, device="cpu")
               for c in (base, cfg)]
    (_, want), (_, got) = (tckpt.load_model(
        os.path.join(f, tckpt.MODEL_FILENAME)) for f in folders)
    for name in want:
        torch.testing.assert_close(got[name], want[name], atol=1e-6,
                                   rtol=1e-6)
    (rec_want,), (rec_got,) = (_records(f) for f in folders)
    _check_record(rec_got, {k: v for k, v in rec_want.items()
                            if k not in TIMES}, lambda k: 1e-6)


def test_clis_need_a_card_unless_asked_for_the_cpu(cohort, trained,
                                                   monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain_cli.main([cohort, "1", "balance"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttest_cli.main([cohort, trained])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttest_cli.main([cohort, trained, "--grid", "g.png"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpredict_cli.main([cohort, trained, "p.csv"])
    assert ttrain_cli.main([cohort]) == 1 and ttest_cli.main([]) == 1
    assert tpredict_cli.main([cohort]) == 1
    assert "Usage" in capsys.readouterr().out


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "skin_image_analysis_tpu",
            "pandas", "PIL", "cv2", "msgpack")


def test_clis_run_without_jax_pandas_pil_cv2_or_msgpack(tmp_path):
    """The card's path: the port's train CLI (a new run, then a resume
    with ``--auto-resume``), test CLI and predict CLI, the explain CLI's
    attribution step and the analysis aggregate on a
    native-pixel DICOM cohort at the canonical size (the test, predict and
    explain CLIs' root holding the frames at the model's size), the torch
    path of ``import_reference`` and the train CLI continuing the folder it
    makes, and the metadata and dataset CLIs (the latter on 224² frames,
    its fixed size), with jax,
    the JAX package, pandas, PIL, cv2 and msgpack unimportable; decoding a
    frame of another size raises an ImportError naming cv2 and PIL, and
    each figure (the test CLI's ``--grid``, the explain and analysis CLIs)
    one naming matplotlib, which needs PIL."""
    root, small = str(tmp_path / "cohort"), str(tmp_path / "cohort16")
    c224 = str(tmp_path / "cohort224")
    ids = write_dicom_cohort(root, 40, 256, 0)
    write_dicom_cohort(small, 0, 16, 0, ids=ids)
    write_dicom_cohort(c224, 0, 224, 0, ids=ids)  # the dataset CLI's size
    shutil.copy(os.path.join(root, "metadata.csv"), c224)
    code = textwrap.dedent(f"""
        import os, sys
        import torch._dynamo
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {_BLOCKED!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        from skin_image_analysis_tpu_torch.cli import (
            tone_bias_analysis, tone_bias_explain, tone_bias_predict,
            tone_bias_test, tone_bias_train)
        from skin_image_analysis_tpu_torch.analysis import read_experiments
        from skin_image_analysis_tpu_torch.data.loader import decode_image
        os.chdir({str(tmp_path)!r})
        args = ["--batch-size", "4", "--image-size", "16",
                "--steps-per-dispatch", "2", "--device", "cpu",
                "--augment"]
        assert tone_bias_train.main([{root!r}, "1", "balance", *args]) == 0
        [folder] = os.listdir("results")
        folder = os.path.join("results", folder)
        assert tone_bias_train.main([{root!r}, "1", folder, *args,
                                     "--auto-resume", "1"]) == 0
        assert tone_bias_test.main([{small!r}, folder, "--device",
                                    "cpu"]) == 0
        # matplotlib imports PIL: every figure names matplotlib, as on a
        # machine without it, and what precedes the figures runs
        out = tone_bias_explain.explain({small!r}, folder, "gradcam", 2,
                                        device="cpu")
        assert out.attributions.shape == (2, 16, 16, 1), out
        agg = read_experiments("results", "balanced")
        assert agg["n_runs"] == 1 and len(agg["epochs"]) == 2, agg
        for run in (
                lambda: tone_bias_test.main([{small!r}, folder, "--device",
                                             "cpu", "--grid", "g.png"]),
                lambda: tone_bias_explain.main([{small!r}, folder,
                                                "--device", "cpu"]),
                lambda: tone_bias_analysis.main(["balanced", "1"])):
            try:
                run()
            except ImportError as e:
                assert "matplotlib" in str(e), e
            else:
                raise AssertionError("a figure without matplotlib")
        assert tone_bias_predict.main([{small!r}, folder, "p.csv",
                                       "--device", "cpu"]) == 0
        assert tone_bias_predict.main([{small!r}, folder, "q.csv",
                                       "--images", "--device", "cpu"]) == 0
        print("rows", len(open("p.csv").readlines()),
              len(open("q.csv").readlines()))
        # a reference-shaped whole module: imported, then trained on
        import shutil
        import torch
        from torch import nn
        from skin_image_analysis_tpu_torch.cli import (
            import_reference, tone_bias_dataset, tone_bias_metadata)
        torch.manual_seed(0)
        ref = nn.Sequential(
            nn.Conv2d(3, 4, 7, padding="same"), nn.ReLU(), nn.MaxPool2d(2),
            nn.Conv2d(4, 6, 3, padding="same"), nn.ReLU(), nn.MaxPool2d(2),
            nn.Flatten(), nn.Linear(6 * 4 * 4, 8), nn.ReLU(),
            nn.Dropout(0.5), nn.Linear(8, 2), nn.LogSoftmax(dim=1))
        os.makedirs("ref")
        torch.save(ref, os.path.join("ref", "session_model.pth"))
        for name in ("session_train.csv", "session_test.csv"):
            shutil.copy(os.path.join(folder, name), "ref")
        assert import_reference.main(["ref", "imported", "--device",
                                      "cpu"]) == 0
        assert tone_bias_train.main([{root!r}, "1", "imported",
                                     *args]) == 0
        assert tone_bias_metadata.main([os.path.join({root!r},
                                                     "metadata.csv")]) == 0
        assert tone_bias_dataset.main([{c224!r}, "balance",
                                       "--device", "cpu"]) == 0
        assert os.path.exists(os.path.join({c224!r},
                                           "balanced_metadata.csv"))
        print("imported", open(os.path.join(
            "imported", "epochs_completed.log")).read().strip())
        try:
            decode_image(os.path.join({root!r}, "{ids[0]}.dcm"), 32)
        except ImportError as e:
            assert "cv2" in str(e) and "PIL" in str(e), e
        else:
            raise AssertionError("a resize without cv2 or PIL")
        assert not [m for m in sys.modules
                    if m.split(".")[0] in {_BLOCKED!r}]
        print("ok", open(os.path.join(folder,
                                      "epochs_completed.log")).read())
    """)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ok 1\n2\n2" in out.stdout  # the auto-resume snapshots each epoch
    assert "imported ->" in out.stdout and "imported 1\n" in out.stdout
    assert "Skin-type x diagnosis grid:" in out.stdout
    assert "iterated " in out.stdout
    assert '"total":' in out.stdout
    n_test = len(pd.read_csv(str(tmp_path / "results" / os.listdir(
        tmp_path / "results")[0] / "session_test.csv")))
    assert f"rows {n_test + 1} 41" in out.stdout  # headers; 40 images

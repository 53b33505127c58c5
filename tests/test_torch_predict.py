"""The port's predict CLI and eval extras against the JAX package's, on the
CPU: ``tone_bias_predict`` on a JAX-trained folder in each mode
(``session_test.csv``, ``--metadata``, ``--images``, ``--best``),
``predict_with_instance``, ``evaluate_model`` and
``evaluate_model_by_class`` over host batches, ``roc_auc_device``,
``cross_entropy_loss``, ``aif360_compat``, ``five_crop_batch`` and the
five-crop eval step."""

import contextlib
import csv
import io
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu.cli import tone_bias_predict as jpredict_cli
from skin_image_analysis_tpu.data import LesionTable as JLesionTable
from skin_image_analysis_tpu.data import (
    read_isic_metadata as jread_isic_metadata,
)
from skin_image_analysis_tpu.data import loader as jloader
from skin_image_analysis_tpu.metrics import aif360_compat as jaif
from skin_image_analysis_tpu.metrics import auc as jauc
from skin_image_analysis_tpu.models.cnn import build_model as jbuild_model
from skin_image_analysis_tpu.ops import losses as jlosses
from skin_image_analysis_tpu.ops import preprocess as jpre
from skin_image_analysis_tpu.train import evaluate as jevaluate
from skin_image_analysis_tpu.train import loop as jloop
from skin_image_analysis_tpu.train import step as jstep
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.cli import tone_bias_predict as tpredict_cli
from skin_image_analysis_tpu_torch.data import loader as tloader
from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.ingest import read_isic_metadata
from skin_image_analysis_tpu_torch.metrics import aif360_compat as taif
from skin_image_analysis_tpu_torch.metrics import auc as tauc
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.ops import losses as tlosses
from skin_image_analysis_tpu_torch.ops import preprocess as tpre
from skin_image_analysis_tpu_torch.train import evaluate as tevaluate
from skin_image_analysis_tpu_torch.train import step as tstep
from tests.fixtures import make_synthetic_dataset
from tests.test_torch_cli import _jax_one_device
from tests.test_torch_train import SMALL_MODEL
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A cohort and a folder the JAX package trained on it, with a
    keep-best model."""
    tmp = tmp_path_factory.mktemp("predict")
    root = str(tmp / "cohort")
    make_synthetic_dataset(root, n=60, seed=13, image_size=32)
    cfg = jconfig.TrainConfig(
        epochs=2, results_dir=str(tmp / "results"), checkpoint_best=True,
        best_metric="loss", log_every_batches=0, seed=0,
        data=jconfig.DataConfig(root_dir=root, image_size=32,
                                canonical_size=32, batch_size=8,
                                balance=False, decode_workers=2, seed=0,
                                steps_per_dispatch=2),
        model=jconfig.ModelConfig(**SMALL_MODEL),
        optim=jconfig.OptimConfig(learning_rate=3e-3))
    with _jax_one_device():
        folder = jloop.run_training(cfg, verbose=False)
    return root, folder, tmp


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("mode", ["test_split", "metadata", "images",
                                  "best"])
def test_predict_cli_matches_jax(trained, mode, tmp_path):
    """The same header, ids, predictions and labels, p_malignant to
    1e-6."""
    root, folder, _ = trained
    flags = {"test_split": [], "best": ["--best"],
             "metadata": ["--metadata", os.path.join(root, "metadata.csv")],
             "images": ["--images"]}[mode]
    if mode == "images":
        # extensions in any case, a stem under two extensions, a stray file
        images = tmp_path / "images"
        images.mkdir()
        names = sorted(n for n in os.listdir(root) if n.endswith(".jpg"))
        for i, name in enumerate(names[:12]):
            stem = name[:-4]
            ext = (".jpg", ".JPG", ".jpeg")[i % 3]
            shutil.copy(os.path.join(root, name), images / (stem + ext))
        shutil.copy(os.path.join(root, names[0]),
                    images / (names[0][:-4] + ".JPEG"))
        (images / "notes.txt").write_text("not an image")
        root = str(images)
    theirs, mine = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    with _jax_one_device(), \
            contextlib.redirect_stdout(io.StringIO()):
        assert jpredict_cli.main([root, folder, theirs, "--batch-size", "8",
                                  *flags]) == 0
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert tpredict_cli.main([root, folder, mine, "--batch-size", "8",
                                  "--device", "cpu", *flags]) == 0
    want, got = _read(theirs), _read(mine)
    assert f"({len(got)} rows)" in out.getvalue()
    with open(theirs) as a, open(mine) as b:
        assert a.readline() == b.readline()  # the header
    assert len(got) == len(want) > 0
    if mode == "images":
        assert len(got) == 12
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            if key == "p_malignant":
                assert float(g[key]) == pytest.approx(float(w[key]),
                                                      abs=1e-6)
            else:
                assert g[key] == w[key], key


def test_predict_cli_usage_and_device(trained, monkeypatch, capsys):
    root, folder, tmp = trained
    assert tpredict_cli.main([root, folder]) == 1
    assert "Usage" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpredict_cli.main([root, folder, str(tmp / "x.csv")])


def _models(seed=0):
    """The port's SMALL_MODEL and the same weights in the JAX package."""
    cfg = tconfig.ModelConfig(**SMALL_MODEL)
    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg, device="cpu", generator=gen)
    params = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(
        model.state_dict(), 32))
    jmodel = jbuild_model(jconfig.ModelConfig(**SMALL_MODEL))
    return model, params, jmodel


@pytest.fixture(scope="module")
def split(trained):
    """One split of the cohort in both packages: tables and host
    stores."""
    root = trained[0]
    frame = read_isic_metadata(root, seed=0)
    table = LesionTable(frame, root)
    jtable = JLesionTable(jread_isic_metadata(root, seed=0), root)
    store = tloader.HostImageStore(table, 32, workers=2)
    with _jax_one_device():
        jstore = jloader.HostImageStore(jtable, 32, workers=2,
                                        layout="planar")
    np.testing.assert_array_equal(store.images, jstore.images)
    return table, jtable, store, jstore


def _loaders(split, bs=8):
    table, jtable, store, jstore = split
    mine = tloader.BatchIterator(store, bs, device="cpu", shuffle=False)
    theirs = jloader.BatchIterator(jstore, bs, shuffle=False, prefetch=0)
    return mine, theirs


def test_predict_with_instance_matches_jax(split):
    model, params, jmodel = _models()
    mine, theirs = _loaders(split)
    pre = tpre.make_preprocess_fn(32, train=False, layout="planar")
    jpre_fn = jpre.make_preprocess_fn(32, train=False, layout="planar")
    got = tevaluate.predict_with_instance(model, mine, split[0], pre)
    want = jevaluate.predict_with_instance(params, jmodel.apply, theirs,
                                           split[1], preprocess_fn=jpre_fn)
    assert sorted(got) == sorted(want) == list(range(len(split[0])))
    assert {g["prediction"] for g in got.values()} <= {"benign", "malignant"}
    for rid in got:
        assert got[rid]["prediction"] == want[rid]["prediction"]
        assert got[rid]["image_name"] == want[rid]["image_name"]
        assert set(got[rid]) == set(want[rid])


@pytest.mark.parametrize("bs", [7, 16])
def test_evaluate_model_and_by_class_match_jax(split, bs):
    """Accuracy and per-class accuracy over host batches, a padded last
    batch included."""
    model, params, jmodel = _models(1)
    pre = tpre.make_preprocess_fn(32, train=False, layout="planar")
    jpre_fn = jpre.make_preprocess_fn(32, train=False, layout="planar")
    mine, theirs = _loaders(split, bs)
    got = tevaluate.evaluate_model(model, mine, pre)
    want = jevaluate.evaluate_model(params, jmodel.apply, theirs, jpre_fn)
    assert got == want
    mine, theirs = _loaders(split, bs)
    got = tevaluate.evaluate_model_by_class(model, mine, 2, pre)
    want = jevaluate.evaluate_model_by_class(params, jmodel.apply, theirs,
                                             2, jpre_fn)
    assert got == want and set(got) == {0, 1}


AUC_CASES = {
    "plain": (40, None, False),
    "ties": (40, None, True),
    "masked": (40, 0.7, False),
    "masked_ties": (64, 0.5, True),
}


@pytest.mark.parametrize("case", list(AUC_CASES))
def test_roc_auc_device_matches_jax_and_host(case):
    n, keep, ties = AUC_CASES[case]
    rng = np.random.default_rng(len(case))
    labels = rng.integers(0, 2, n)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4  # a handful of distinct values
    valid = None if keep is None else rng.random(n) < keep
    got = tauc.roc_auc_device(
        torch.from_numpy(labels), torch.from_numpy(scores),
        None if valid is None else torch.from_numpy(valid))
    want = jauc.roc_auc_device(
        jnp.asarray(labels), jnp.asarray(scores),
        None if valid is None else jnp.asarray(valid))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    sel = slice(None) if valid is None else valid
    assert float(got) == pytest.approx(
        tauc.roc_auc(labels[sel], scores[sel]), abs=1e-6)


def test_roc_auc_device_one_class_is_nan():
    got = tauc.roc_auc_device(torch.ones(5, dtype=torch.long),
                              torch.rand(5))
    assert torch.isnan(got)


@pytest.mark.parametrize("weights", [None, (0.3, 1.7, 1.0)])
def test_cross_entropy_loss_matches_jax(weights):
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(9, 3)) * 5).astype(np.float32)
    labels = rng.integers(0, 3, 9)
    got = tlosses.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if weights is None else torch.tensor(weights))
    want = jlosses.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if weights is None else jnp.asarray(weights))
    assert float(got) == pytest.approx(float(want), rel=1e-6)


AIF_FUNCS = ("statistical_parity_difference", "disparate_impact",
             "equal_opportunity_difference", "average_odds_difference")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aif360_compat_matches_jax(seed):
    """Every metric, and the report from a DI dict, on random counts;
    seed 2 has an empty majority group (the zero guards)."""
    rng = np.random.default_rng(seed)
    counts = [int(c) for c in rng.integers(0, 20, 8)]
    if seed == 2:
        counts[4:] = [0, 0, 0, 0]
    for name in AIF_FUNCS:
        assert getattr(taif, name)(*counts) == getattr(jaif, name)(*counts)
    keys = ("tp_min", "tn_min", "fp_min", "fn_min", "tp_maj", "tn_maj",
            "fp_maj", "fn_maj")
    di = dict(zip(keys, counts))
    assert taif.classification_metric_report(di) \
        == jaif.classification_metric_report(di)


@pytest.mark.parametrize("shape,size", [((2, 9, 11, 3), 5),
                                        ((1, 8, 8, 3), 8)])
def test_five_crop_batch_matches_jax(shape, size):
    x = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    got = tpre.five_crop_batch(torch.from_numpy(x), size)
    want = np.asarray(jpre.five_crop_batch(jnp.asarray(x), size))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="five_crop"):
        tpre.five_crop_batch(torch.from_numpy(x), shape[1] + 1)


@pytest.mark.parametrize("norm", [False, True])
def test_five_crop_eval_step_matches_jax(norm):
    """Log-probs averaged over the five crops: to 1e-5, the same
    predictions, row ids and valid flags."""
    model, params, jmodel = _models(2)
    rng = np.random.default_rng(4)
    pixels = rng.integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    row_id = np.array([4, 7, -1], np.int32)
    valid = np.array([True, True, False])
    got = tstep.make_five_crop_eval_step(32, normalize_imagenet=norm)(
        model, torch.from_numpy(pixels), torch.from_numpy(row_id),
        torch.from_numpy(valid))
    want = jstep.make_five_crop_eval_step(32, normalize_imagenet=norm)(
        params, jmodel.apply, {"pixels": jnp.asarray(pixels),
                               "row_id": jnp.asarray(row_id),
                               "valid": jnp.asarray(valid)})
    np.testing.assert_allclose(got["log_probs"].numpy(),
                               np.asarray(want["log_probs"]), atol=1e-5,
                               rtol=0)
    for key in ("pred", "row_id", "valid"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))

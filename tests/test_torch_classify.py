"""The port's transfer trainer (``train/classify.py``) and its pieces
against the JAX package's, on the CPU: the metrics, class weights, the
oversampler's draws, the split files, the HAM ingest, the augmented
train preprocess, and whole ``train_classifier`` runs of both packages
from the same initial weights."""

import csv
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu.data.dataset import LesionTable as JLesionTable
from skin_image_analysis_tpu.data.ham import (
    attach_ita_tone as j_attach_ita_tone,
    read_ham_metadata as j_read_ham_metadata,
)
from skin_image_analysis_tpu.data.loader import BatchIterator as JBatchIterator
from skin_image_analysis_tpu.ops import preprocess as jpre
from skin_image_analysis_tpu.toneclassifier import class_weight as jcw
from skin_image_analysis_tpu.toneclassifier.split import (
    split_metadata_csv as j_split,
)
from skin_image_analysis_tpu.train import classify as jclassify
from skin_image_analysis_tpu.utils.metrics_log import (
    binary_metrics as j_binary_metrics,
)
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.ham import (
    DX_CLASSES,
    attach_ita_tone,
    read_ham_metadata,
)
from skin_image_analysis_tpu_torch.data.ingest import read_csv
from skin_image_analysis_tpu_torch.data.loader import (
    BatchIterator,
    HostImageStore,
)
from skin_image_analysis_tpu_torch.ops import preprocess as tpre
from skin_image_analysis_tpu_torch.toneclassifier import class_weight as tcw
from skin_image_analysis_tpu_torch.toneclassifier.split import (
    split_metadata_csv,
)
from skin_image_analysis_tpu_torch.train import classify as tclassify
from skin_image_analysis_tpu_torch.utils.metrics_log import binary_metrics
from tests.test_torch_ita import write_skin_jpegs
from tests.test_torch_native_loader import same_decoders
from tests.test_torch_resnet import jax_create_train_state, nodrop_models
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def write_ham_root(root, n: int = 42, seed: int = 0) -> str:
    """A HAM-style folder: 32x32 JPEGs and a 7-class ``dx`` metadata CSV
    (``tests/test_classify.py``'s fixture, written here)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        image_id = f"ISIC_{i:07d}"
        rows.append({"lesion_id": f"HAM_{i}", "image_id": image_id,
                     "dx": DX_CLASSES[i % 7], "dx_type": "histo",
                     "age": 50, "sex": "male", "localization": "back"})
        shade = 30 + 30 * (i % 7)
        img = (rng.integers(0, 40, (32, 32, 3)) + shade).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"{image_id}.jpg"))
    with open(os.path.join(root, "HAM10000_metadata.csv"), "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(root)


@pytest.fixture(scope="module")
def ham_root(tmp_path_factory):
    return write_ham_root(tmp_path_factory.mktemp("ham"))


@pytest.fixture(scope="module")
def skin_root(synth_root, tmp_path_factory):
    """The synthetic cohort with skin-coloured JPEGs (light for benign,
    dark for malignant rows; the grey frames of ``synth_root`` have almost
    no pixel in the ITA skin gamut). The noise of 40 a channel leaves
    about a sixth of the pixels in the gamut, so both ITA channels vary
    as over a lesion photo's skin and lesion. With 12, nearly every pixel
    is skin, both channels are nearly constant, and train-mode BatchNorm
    over such a stem divides by tiny deviations: the packages' first
    losses then part by 3e-5 and the third by 2e-3."""
    root = str(tmp_path_factory.mktemp("skin") / "cohort")
    shutil.copytree(synth_root, root)
    write_skin_jpegs(root, seed=3, noise=40)
    return root


@pytest.mark.parametrize("n_classes", [2, 3, 7])
def test_multiclass_and_binary_metrics_match_jax(n_classes):
    rng = np.random.default_rng(n_classes)
    preds = rng.integers(0, n_classes, 50)
    labels = rng.integers(0, n_classes, 50)
    assert tclassify.multiclass_metrics(preds, labels, n_classes) == \
        jclassify.multiclass_metrics(preds, labels, n_classes)
    b = (preds % 2, labels % 2)
    assert binary_metrics(*b) == j_binary_metrics(*b)
    assert tclassify.multiclass_metrics([], [], 3) == \
        jclassify.multiclass_metrics([], [], 3)


def test_class_weights_match_jax():
    labels = np.repeat([0, 1, 2], [3, 9, 5])
    np.testing.assert_array_equal(tcw.balanced_class_weights(labels, 3),
                                  jcw.balanced_class_weights(labels, 3))
    with pytest.raises(ValueError, match="empty class"):
        tcw.balanced_class_weights([0, 0], 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oversampled_order_matches_jax(seed):
    labels = np.random.default_rng(10 + seed).integers(0, 3, 40)
    np.testing.assert_array_equal(
        tclassify._oversampled_order(labels, np.random.default_rng(seed)),
        jclassify._oversampled_order(labels, np.random.default_rng(seed)))


def test_batch_iterator_order_fn_matches_jax(synth_root):
    """``order_fn(rng)`` replaces the shuffle, epoch after epoch, from the
    iterator's seeded generator."""
    df = read_csv(os.path.join(synth_root, "metadata.csv")).where(
        "benign_malignant", lambda v: v in ("benign", "malignant"))
    table = LesionTable(df, synth_root)
    store = HostImageStore(table, 16)
    labels = table.labels

    def order_fn(rng):
        return jclassify._oversampled_order(labels, rng)

    mine = BatchIterator(store, 4, device="cpu", seed=3, order_fn=order_fn)
    theirs = JBatchIterator(store, 4, seed=3, order_fn=order_fn)
    for _ in range(3):
        np.testing.assert_array_equal(mine.epoch_order(),
                                      theirs._epoch_order())


def test_split_metadata_csv_matches_jax(synth_root, tmp_path):
    """The same rows in the same order, byte for byte."""
    src = os.path.join(synth_root, "metadata.csv")
    for seed in (0, 5):
        (tmp_path / "t").mkdir(exist_ok=True)
        (tmp_path / "j").mkdir(exist_ok=True)
        mine = split_metadata_csv(src, str(tmp_path / "t"), seed=seed)
        theirs = j_split(src, str(tmp_path / "j"), seed=seed)
        for a, b in zip(mine, theirs):
            assert os.path.basename(a) == os.path.basename(b)
            assert open(a, "rb").read() == open(b, "rb").read()


def _cells(df: pd.DataFrame):
    """pandas cells as the port's strings (None where missing)."""
    return [[None if pd.isna(v) else str(v) for v in row]
            for row in df.itertuples(index=False)]


def test_read_ham_metadata_and_ita_tone_match_jax(ham_root, tmp_path):
    path = os.path.join(ham_root, "HAM10000_metadata.csv")
    mine, theirs = read_ham_metadata(path), j_read_ham_metadata(path)
    assert mine.columns == list(theirs.columns)
    assert mine.rows == _cells(theirs)
    # HAM's own columns without sex and age: both added as pandas adds them
    bare = tmp_path / "bare.csv"
    pd.read_csv(path).drop(columns=["sex"]).rename(
        columns={"age": "age_x"}).to_csv(bare, index=False)
    mine, theirs = read_ham_metadata(str(bare)), j_read_ham_metadata(bare)
    assert mine.columns == list(theirs.columns)
    assert mine.rows == _cells(theirs)
    ita = {"ISIC_0000000": 50.0, "ISIC_0000001": 12.0,
           "ISIC_0000002": float("nan"), "ISIC_0000003": 41.0}
    full = read_ham_metadata(path)
    assert attach_ita_tone(full, ita).column("skin_tone") == \
        [None if pd.isna(v) else v for v in j_attach_ita_tone(
            j_read_ham_metadata(path), ita)["skin_tone"]]
    bad = tmp_path / "bad.csv"
    bad.write_text("image_id,age\nISIC_1,4\n")
    with pytest.raises(ValueError, match="not a HAM-10000"):
        read_ham_metadata(str(bad))


def test_augmented_train_preprocess_matches_jax():
    """The transfer step's train preprocess (crop 40 -> 32, flip, the
    ImageNet affine, float32 out; no jitter): the port's planar path
    (the kernel's plain twin on the CPU) on JAX's draws, replayed, equals
    JAX's hwc ``preprocess_batch``."""
    b, s, t = 6, 40, 32
    rng = np.random.default_rng(4)
    arena = rng.integers(0, 256, (10, 3, s, s), dtype=np.uint8)
    rows = np.array([3, 0, 9, 9, 5, 1], np.int32)
    key = jax.random.key(8)
    augment = jpre.AugmentConfig(random_crop=True, horizontal_flip=True)
    want = jpre.preprocess_batch(
        jnp.asarray(arena[rows].transpose(0, 2, 3, 1)), key, image_size=t,
        train=True, augment=augment, normalize_imagenet=True)
    key, sub = jax.random.split(key)
    ky, kx = jax.random.split(sub)
    ys = jax.random.randint(ky, (b,), 0, s - t + 1)
    xs = jax.random.randint(kx, (b,), 0, s - t + 1)
    key, sub = jax.random.split(key)
    flips = jax.random.bernoulli(sub, 0.5, (b, 1, 1, 1)).reshape(b)
    draws = tpre.AugmentDraws(
        torch.from_numpy(np.stack([ys, xs], 1).astype(np.int32)),
        torch.from_numpy(np.asarray(flips).astype(np.int32)),
        None, None, None)
    got = tpre.preprocess_planar_batch(
        torch.from_numpy(arena), image_size=t, train=True,
        augment=tpre.AugmentConfig(random_crop=True, horizontal_flip=True),
        normalize_imagenet=True, rows=torch.from_numpy(rows), draws=draws)
    assert got.dtype == torch.float32 and got.shape == (b, t, t, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    fn = tpre.make_preprocess_fn(
        t, train=True, augment=tpre.AugmentConfig(True, True),
        normalize_imagenet=True, layout="planar")
    assert fn.supports_rows  # the kernel's path, with the gather fused


def _jax_tables(kind, root):
    if kind == "synth":
        df = pd.read_csv(os.path.join(root, "metadata.csv"))
        df = df[df["fitzpatrick_skin_type"].notna()
                & df["benign_malignant"].isin(["benign", "malignant"])]
        kw = {}
    else:
        df = j_read_ham_metadata(os.path.join(root, "HAM10000_metadata.csv"))
        kw = dict(class_names=DX_CLASSES, label_column="dx")
    return [JLesionTable(d, root, **kw) for d in (df[:28], df[28:])]


def _port_tables(kind, root):
    if kind == "synth":
        df = read_csv(os.path.join(root, "metadata.csv"))
        df = df.where("fitzpatrick_skin_type", lambda v: v is not None)
        df = df.where("benign_malignant",
                      lambda v: v in ("benign", "malignant"))
        kw = {}
    else:
        df = read_ham_metadata(os.path.join(root, "HAM10000_metadata.csv"))
        kw = dict(class_names=DX_CLASSES, label_column="dx")
    return [LesionTable(d, root, **kw)
            for d in (df.take(range(28)), df.take(range(28, len(df))))]


def _records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return ([r["train_loss"] for r in recs if "train_loss" in r],
            [r for r in recs if "accuracy" in r])


CASES = {
    # tone-style binary labels, one step a call, keep-best on accuracy
    "synth": dict(num_classes=2, batch_size=7, epochs=3,
                  steps_per_dispatch=1, checkpoint_best=True,
                  early_stop_patience=2),
    # 7-class dx, oversampled, 2 steps a call, five-crop eval, keep-best
    # and a stop after one epoch without a better accuracy
    "ham": dict(num_classes=7, batch_size=7, epochs=3, steps_per_dispatch=2,
                oversample=True, five_crop_eval=True, checkpoint_best=True,
                early_stop_patience=1),
    # the tone labels on the two ITA channels (a 2-channel stem), one
    # step a call; then 2 steps a call with five-crop eval
    "ita": dict(num_classes=2, batch_size=7, epochs=2, steps_per_dispatch=1,
                input_mode="ita", checkpoint_best=True),
    "ita_five_crop": dict(num_classes=2, batch_size=7, epochs=2,
                          steps_per_dispatch=2, input_mode="ita",
                          five_crop_eval=True, checkpoint_best=True),
}
EPOCHS_RUN = {"synth": 3, "ham": 2, "ita": 2, "ita_five_crop": 2}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_train_classifier_matches_jax(kind, synth_root, ham_root, skin_root,
                                      tmp_path, monkeypatch):
    """Both packages' ``train_classifier`` from the JAX run's initial
    weights (resnet18 with the head's dropout off, 32 of 40 px, float32,
    augment off): equal per-epoch accuracy, precision, recall and F1, AUC
    to 1e-6, per-step losses to rtol 1e-4, the same keep-best and
    early-stop epochs and the same out-dir files.

    The runs take sgd at lr 1e-3 and batches of 7. A ResNet's training at
    this size is chaotic: train-mode BatchNorm over a handful of values a
    channel amplifies float32 rounding step after step, and adam's
    sign-like first updates flip with it. With adamw at lr 1e-3 and B=4
    the JAX package's own one-step and two-step dispatch part by 1% in the
    first epoch; sgd at lr 0.05 parts the two packages by 4e-4 at the
    third step. adamw's update is held over one step in
    ``tests/test_torch_resnet.py``. The ``ita`` cases run the tone labels
    with ``input_mode="ita"``: no ImageNet normalization, the two ITA
    channels into a 2-channel stem, on skin-coloured frames."""
    tables = "ham" if kind == "ham" else "synth"
    root = {"synth": synth_root, "ham": ham_root}.get(kind, skin_root)
    init = {}
    make_t = tclassify.create_train_state

    def capture(*a, **k):
        state, model = jax_create_train_state(*a, **k)
        init["params"] = jax.tree.map(np.array, state.params)
        init["stats"] = jax.tree.map(np.array, state.batch_stats)
        return state, model

    def carry(model_cfg, optim_cfg, seed, device):
        state = make_t(model_cfg, optim_cfg, seed, device)
        state.model.load_state_dict(bridge.variables_to_state_dict(
            init["params"], init["stats"], model_cfg.image_size))
        return state

    same_decoders(monkeypatch)
    monkeypatch.setattr(jclassify, "create_train_state", capture)
    monkeypatch.setattr(tclassify, "create_train_state", carry)
    with nodrop_models() as name:
        kw = dict(CASES[kind], model_name=name, image_size=32,
                  canonical_size=40, compute_dtype="float32", augment=False,
                  optimizer="sgd", learning_rate=1e-3)
        jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
        jout = jclassify.train_classifier(
            *_jax_tables(tables, root),
            jclassify.ClassifyConfig(out_dir=jdir, **kw), verbose=False)
        tout = tclassify.train_classifier(
            *_port_tables(tables, root),
            tclassify.ClassifyConfig(out_dir=tdir, **kw), verbose=False,
            device="cpu")
    if kind.startswith("ita"):
        assert tout["state"].model.stem_conv.weight.shape[1] == 2
    jh, th = jout["history"], tout["history"]
    assert len(th) == len(jh) == EPOCHS_RUN[kind]
    for a, b in zip(th, jh):
        for key in ("accuracy", "precision", "recall", "f1", "epoch"):
            assert a[key] == b[key], (key, a, b)
        assert ("auc" in a) == ("auc" in b) == (kind != "ham")
        if "auc" in a:
            assert abs(a["auc"] - b["auc"]) <= 1e-6
        np.testing.assert_allclose(a["train_loss_mean"],
                                   b["train_loss_mean"], rtol=1e-4)
    (tl, trec), (jl, jrec) = _records(tdir), _records(jdir)
    assert len(tl) == len(jl) > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert [r["step"] for r in trec] == [r["step"] for r in jrec]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert "session_model_best.msgpack" in os.listdir(tdir)
    with open(os.path.join(tdir, "train_config.json")) as f:
        mine = json.load(f)
    with open(os.path.join(jdir, "train_config.json")) as f:
        theirs = json.load(f)
    assert mine["data"] == theirs["data"]
    assert mine["class_names"] == theirs["class_names"]
    assert {k: v for k, v in mine["classify"].items() if k != "out_dir"} \
        == {k: v for k, v in theirs["classify"].items() if k != "out_dir"}
    for name in ("session_train.csv", "session_test.csv"):
        ids = [pd.read_csv(os.path.join(d, name))["isic_id"].tolist()
               for d in (tdir, jdir)]
        assert ids[0] == ids[1]


@pytest.mark.parametrize("bad,match", [
    (dict(input_mode="hsv"), "rgb|ita"),
    (dict(five_crop_eval=True, canonical_size=32), "five_crop_eval"),
    (dict(checkpoint_best=True, best_metric="nope"), "nope"),
    (dict(num_classes=7, early_stop_patience=1, best_metric="auc"),
     "needs num_classes == 2"),
])
def test_train_classifier_refuses_configs_as_jax_does(bad, match, synth_root,
                                                      tmp_path):
    """Refused up front, before any decode or file, with the JAX
    package's ValueError."""
    cfg = {**dict(image_size=32, canonical_size=40, out_dir=str(tmp_path)),
           **bad}
    with pytest.raises(ValueError, match=match):
        tclassify.train_classifier(*_port_tables("synth", synth_root),
                                   tclassify.ClassifyConfig(**cfg),
                                   verbose=False, device="cpu")
    with pytest.raises(ValueError, match=match):
        jclassify.train_classifier(*_jax_tables("synth", synth_root),
                                   jclassify.ClassifyConfig(**cfg),
                                   verbose=False)
    assert not os.listdir(tmp_path)


def test_ita_input_is_refused_after_validation(synth_root, tmp_path):
    """``input_mode="ita"`` passes the validation; an ITA config that
    fails it is refused before any decode or file, as an RGB one is."""
    tables = _port_tables("synth", synth_root)
    cfg = dict(image_size=32, canonical_size=40, out_dir=str(tmp_path),
               input_mode="ita")
    tclassify._validate(tclassify.ClassifyConfig(**cfg))
    with pytest.raises(ValueError, match="five_crop_eval"):
        tclassify.train_classifier(
            *tables, tclassify.ClassifyConfig(**{**cfg, "canonical_size": 32},
                                              five_crop_eval=True),
            verbose=False, device="cpu")
    assert not os.listdir(tmp_path)

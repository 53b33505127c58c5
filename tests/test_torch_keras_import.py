"""The port's import of the reference TF pipeline's ``.keras`` artifacts
against the JAX package's, on the CPU: the cases of
``tests/test_keras_import.py`` on two families, Xception (the artifact
the notebook saves, a pure 0-255 scale folded into the stem) and
EfficientNetV2-S (its ``Rescaling(1/128, -1)`` carried as the pipeline's
``input_affine``). Each artifact is saved once and imported once by each
package (module fixtures); the folders must be byte-identical and the
port's forward must match Keras's. Needs keras (and its h5py); the
card's machine has no h5py, so these run on the CPU only."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from skin_image_analysis_tpu import migrate as jmigrate
from skin_image_analysis_tpu.migrate import keras_model as jkeras_model
from skin_image_analysis_tpu_torch import migrate as tmigrate
from skin_image_analysis_tpu_torch.cli import import_reference as timport_cli
from skin_image_analysis_tpu_torch.migrate import keras_model as tkeras_model
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.models.efficientnet import (
    _B0_STAGES,
    round_repeats,
)
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 96


def _folder_bytes(folder) -> dict:
    return {n: open(os.path.join(folder, n), "rb").read()
            for n in sorted(os.listdir(folder))}


def _port_log_probs(folder, x):
    cfg, state_dict = tckpt.load_model(
        os.path.join(folder, tckpt.MODEL_FILENAME))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict)
    model.eval()
    with torch.no_grad():
        return cfg, model(torch.from_numpy(x), train=False).numpy()


def _import_both(tmp, path, **kw):
    """Each package's import of ``path`` into its own folder: (port
    summary, JAX summary, port folder, JAX folder)."""
    out_t, out_j = str(tmp / "port"), str(tmp / "jax")
    return (tmigrate.import_keras_experiment(path, out_t, **kw),
            jmigrate.import_keras_experiment(path, out_j, **kw),
            out_t, out_j)


@pytest.fixture(scope="module")
def xception(tmp_path_factory):
    """The notebook's Xception transfer model at 96², saved and imported
    by both packages."""
    keras = pytest.importorskip("keras")
    from tests.test_keras_import import _notebook_transfer_model

    tmp = tmp_path_factory.mktemp("xception")
    keras.utils.set_random_seed(7)  # keras inits from TF's global rng
    kmodel = _notebook_transfer_model(keras, num_classes=2, size=SIZE)
    path = str(tmp / "skin_cancer_xception_model.keras")
    kmodel.save(path)
    return dict(keras=keras, kmodel=kmodel, path=path, tmp=tmp,
                imported=_import_both(tmp, path))


@pytest.fixture(scope="module")
def efficientnet_v2_s(tmp_path_factory):
    """EfficientNetV2-S with tame random BatchNorm statistics (the JAX
    test's: its ~170 BatchNorm+swish layers are chaotic at +-50%)."""
    keras = pytest.importorskip("keras")
    from tests.test_vgg_mobilenet import _transfer_model

    tmp = tmp_path_factory.mktemp("env2s")
    keras.utils.set_random_seed(12)
    rng = np.random.default_rng(12)
    base = keras.applications.EfficientNetV2S(
        weights=None, include_top=False, input_shape=(SIZE, SIZE, 3))
    kmodel = _transfer_model(keras, base, num_classes=2)
    for layer in kmodel.layers:
        if isinstance(layer, keras.layers.BatchNormalization):
            c = layer.get_weights()[0].shape[0]
            layer.set_weights([
                rng.uniform(0.95, 1.05, c).astype(np.float32),
                rng.normal(0, 0.02, c).astype(np.float32),
                rng.normal(0, 0.02, c).astype(np.float32),
                rng.uniform(0.95, 1.05, c).astype(np.float32),
            ])
    path = str(tmp / "env2s.keras")
    kmodel.save(path)
    return dict(keras=keras, kmodel=kmodel, path=path, tmp=tmp, rng=rng,
                imported=_import_both(tmp, path))


def test_xception_import_matches_jax_and_keras(xception):
    ours, theirs, out_t, out_j = xception["imported"]
    assert ours == theirs
    assert ours["backbone"] == "xception" and ours["num_classes"] == 2
    assert ours["image_size"] == SIZE
    assert ours["input_scale_folded"] == 255.0
    assert ours["class_names"] == ["benign", "malignant"]
    assert _folder_bytes(out_t) == _folder_bytes(out_j)
    with open(os.path.join(out_t, "train_config.json")) as f:
        assert json.load(f)["data"]["normalize_imagenet"] is False

    # the notebook feeds raw 0-255, the port's pipeline [0, 1]
    x_255 = np.random.default_rng(1).uniform(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(xception["kmodel"](x_255, training=False))
    cfg, got = _port_log_probs(out_t, x_255 / 255.0)
    assert cfg.name == "xception" and cfg.compute_dtype == "float32"
    np.testing.assert_allclose(np.exp(got), want, rtol=1e-3, atol=1e-5)


def test_efficientnet_v2_s_input_affine_matches_jax_and_keras(
        efficientnet_v2_s):
    """The offset rides as ``input_affine`` (255/128 x01 - 1); the
    affine-fed forward equals Keras's raw-0-255 forward, held on the
    log-probs against Keras's own logits, to a tolerance proportional to
    their scale (the JAX test's: softmax saturates there)."""
    ours, theirs, out_t, out_j = efficientnet_v2_s["imported"]
    assert ours == theirs
    assert ours["backbone"] == "efficientnet_v2_s"
    assert ours["normalize_imagenet"] is False
    assert ours["input_scale_folded"] == 1.0
    scale, offset = ours["input_affine"]
    assert np.allclose(scale, 255.0 / 128.0) and np.allclose(offset, -1.0)
    assert _folder_bytes(out_t) == _folder_bytes(out_j)
    with open(os.path.join(out_t, "train_config.json")) as f:
        assert json.load(f)["data"]["input_affine"] == ours["input_affine"]

    keras, kmodel = efficientnet_v2_s["keras"], efficientnet_v2_s["kmodel"]
    x_255 = efficientnet_v2_s["rng"].uniform(
        0, 255, (2, SIZE, SIZE, 3)).astype(np.float32)
    _, got = _port_log_probs(out_t, (x_255 / 255.0) * (255.0 / 128.0) - 1.0)
    feat = np.asarray(keras.Model(kmodel.input, kmodel.layers[-2].output)(
        x_255, training=False))
    w, b = kmodel.layers[-1].get_weights()
    logits = feat @ w + b
    top = logits.max(-1, keepdims=True)
    ref = logits - top - np.log(np.exp(logits - top).sum(-1, keepdims=True))
    atol = max(1e-4 * float(np.abs(logits).max()), 1e-4)
    np.testing.assert_allclose(got, ref, atol=atol)


def test_both_clis_give_the_same_folder(xception, capsys):
    """The port's CLI with ``--classes light,dark`` writes the JAX
    import's folder with those class names (the JAX CLI passes
    ``--classes`` to the same import); the wrong number of class names is
    refused with the JAX import's message. Each run loads the artifact,
    so the JAX side is the fixture's import."""
    tmp, path = xception["tmp"], xception["path"]
    out_j = xception["imported"][3]
    assert timport_cli.main([path, str(tmp / "cli_t"), "--classes",
                             "light,dark", "--device", "cpu"]) == 0
    assert "imported ->" in capsys.readouterr().out
    mine, theirs = _folder_bytes(tmp / "cli_t"), _folder_bytes(out_j)
    config = {n: json.loads(f.pop("train_config.json"))
              for n, f in (("port", mine), ("jax", theirs))}
    assert mine == theirs
    assert config["port"] == {**config["jax"],
                              "class_names": ["light", "dark"]}
    assert timport_cli.main([path, str(tmp / "x"), "--classes", "a,b,c",
                             "--device", "cpu"]) == 1
    assert "import failed: 3 class names for 2 classes" \
        in capsys.readouterr().out


def test_refusals_match_jax(tmp_path):
    keras = pytest.importorskip("keras")
    tiny = keras.Sequential([
        keras.Input((16, 16, 3)), keras.layers.Conv2D(4, 3),
        keras.layers.GlobalAveragePooling2D(),
        keras.layers.Dense(2, activation="softmax")])
    tiny.save(str(tmp_path / "tiny.keras"))
    (tmp_path / "bad.keras").write_bytes(b"\x00\x01not a zip")
    for name, match in (("tiny.keras", "unrecognized backbone"),
                        ("bad.keras", "not a loadable")):
        path = str(tmp_path / name)
        with pytest.raises(tmigrate.KerasImportError, match=match):
            tmigrate.import_keras_model(path)
        with pytest.raises(jmigrate.KerasImportError, match=match):
            jmigrate.import_keras_model(path)


def test_without_keras_the_import_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "keras", None)  # import raises
    with pytest.raises(tmigrate.KerasImportError, match="requires keras"):
        tmigrate.import_keras_model(str(tmp_path / "m.keras"))


MEAN = [0.485, 0.456, 0.406]
VAR = [0.229 ** 2, 0.224 ** 2, 0.225 ** 2]


@pytest.mark.parametrize("stack", [
    [],
    [("rescaling", 1 / 255.0, 0.0)],
    [("rescaling", 2.0, 0.0), ("rescaling", 0.5, 0.0)],
    [("rescaling", 1 / 255.0, 0.0), ("normalization", [0.0] * 3,
                                     [1.0] * 3)],
    [("rescaling", 1 / 255.0, 0.0), ("normalization", MEAN, VAR)],
    [("rescaling", 1 / 255.0, 0.0), ("normalization", MEAN, VAR),
     ("rescaling", [1 / s for s in (0.229, 0.224, 0.225)], 0.0)],
    [("rescaling", 1 / 128.0, -1.0)],
], ids=["raw", "scale", "scales", "identity_norm", "imagenet",
        "imagenet_v1", "offset"])
def test_compose_input_transform_matches_jax(stack):
    fold, norm, affine = tkeras_model.compose_input_transform(stack)
    jfold, jnorm, jaffine = jkeras_model.compose_input_transform(stack)
    np.testing.assert_array_equal(fold, jfold)
    assert fold.dtype == jfold.dtype
    assert norm == jnorm and affine == jaffine


def test_efficientnet_b1_b2_candidates_match_jax():
    """b1 and b2 share their block counts: both packages return both, in
    the same order (names only, no model)."""
    names = ["input_layer", "rescaling", "normalization", "stem_conv",
             "stem_bn", "top_conv", "top_bn", "predictions"]
    for stage_i, (_, _, repeats, _, _) in enumerate(_B0_STAGES, start=1):
        for rep in range(round_repeats(repeats, 1.1)):
            p = f"block{stage_i}{chr(ord('a') + rep)}"
            names += [f"{p}_dwconv", f"{p}_project_conv", f"{p}_bn"]
    got = [c[0] for c in tkeras_model._detect_family(names)]
    assert got == [c[0] for c in jkeras_model._detect_family(names)]
    assert got == ["efficientnet_b1", "efficientnet_b2"]

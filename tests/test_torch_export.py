"""The port's ``torch.export`` artifact (``serve/export.py``) against the
JAX package's ``jax.export`` one and against the folder session, on the
CPU: the manifest's keys, the artifact's answers at a width that reaches
the selector pools, on resized, normalized, ITA and resnet18 folders, the
fixed-batch and batch-range padding, the fallback to a fixed batch,
the refusals, and the export CLI."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from skin_image_analysis_tpu.serve import export as jexport
from skin_image_analysis_tpu_torch.cli import tone_bias_export
from skin_image_analysis_tpu_torch.serve import export as texport
from skin_image_analysis_tpu_torch.serve.server import (
    InferenceSession,
    start_reload_watcher,
)
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from tests.test_torch_serve import (
    FLAGSHIP,
    KINDS,
    assert_same_answers,
    jax_folder,
    kind_folder,
    one_torch_thread,  # noqa: F401  (the shared fixture)
    pixels,
)


pytestmark = pytest.mark.usefixtures("one_torch_thread")

# conv1 with 36 features packs 144 channels, past the phase pools' 128:
# it runs the selector pools, as the flagship's conv1 and conv2 at 224²
SELECTOR = dict(FLAGSHIP, conv_features=(4, 36), image_size=64)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return jax_folder(tmp_path_factory.mktemp("export") / "flagship",
                      FLAGSHIP)


@pytest.fixture(scope="module")
def selector(tmp_path_factory):
    """A selector-width folder, its artifact and its folder session."""
    tmp = tmp_path_factory.mktemp("export_selector")
    folder = jax_folder(tmp / "exp", SELECTOR, seed=2)
    out = str(tmp / "m.pt2")
    manifest = texport.export_model(folder, out, device="cpu")
    return folder, out, manifest, InferenceSession.from_experiment(
        folder, max_batch=8, device="cpu")


def test_manifest_keys_match_jax(folder, tmp_path):
    jman = jexport.export_model(folder, str(tmp_path / "m.stablehlo"))
    man = texport.export_model(folder, str(tmp_path / "m.pt2"),
                               device="cpu")
    assert set(jman) <= set(man)
    assert man["format"] == "torch.export/ExportedProgram"
    for k in ("input", "outputs", "class_names", "image_size",
              "canonical_size", "normalize_imagenet", "input_affine",
              "quantization", "model", "experiment_folder"):
        assert man[k] == jman[k], k
    assert man["platforms"] == ["cpu"]
    assert man["bytes"] == os.path.getsize(tmp_path / "m.pt2")
    lo, hi = man["batch_range"]
    assert 1 <= lo <= 2 and hi == texport.MAX_BATCH
    with open(tmp_path / "m.pt2.json") as f:
        assert json.load(f) == man


@pytest.mark.parametrize("n", [1, 3, 11])
def test_artifact_matches_folder_session(selector, n):
    """``from_artifact`` (n = 1, padded, above max_batch) and
    ``predict_exported`` against the folder session, at the selector
    width."""
    folder, out, manifest, sess = selector
    assert manifest["input"]["shape"] == ["symbolic", 64, 64, 3]
    art = InferenceSession.from_artifact(out, max_batch=8, device="cpu")
    assert (art.image_size, art.in_channels) == (64, 3)
    assert art.class_names == sess.class_names
    px = pixels(n, 64, seed=n)
    want = sess.predict(px)
    assert_same_answers(art.predict(px), want)
    assert_same_answers(texport.predict_exported(out, px, device="cpu"),
                        want)


@pytest.mark.parametrize("kind", ["flagship", "resnet18", "affine", "ita"])
def test_artifact_matches_jax_artifact(kind, tmp_path):
    """Both packages' artifacts of one folder on the same pixels; the
    flagship's at canonical size 20, so the program resizes."""
    folder = kind_folder(tmp_path, kind, seed=3)
    size = 20 if kind == "flagship" else None
    jout, out = str(tmp_path / "m.stablehlo"), str(tmp_path / "m.pt2")
    jman = jexport.export_model(folder, jout, canonical_size=size)
    man = texport.export_model(folder, out, canonical_size=size,
                               device="cpu")
    assert man["input"]["shape"] == jman["input"]["shape"]
    assert man["normalize_imagenet"] == jman["normalize_imagenet"]
    assert man["class_names"] == jman["class_names"]
    s = man["canonical_size"]
    px = pixels(3, s, seed=4)
    want = jexport.load_exported(jout).call(jnp.asarray(px))
    assert_same_answers(texport.predict_exported(out, px, device="cpu"),
                        {k: np.asarray(v) for k, v in want.items()})


def _fixed(folder: str, out: str, batch: int = 4, low: int | None = None):
    """An artifact of a fixed ``batch``, or with ``low`` a dynamic batch
    whose range starts at ``low``, written as ``export_model`` would."""
    cfg, state_dict = tckpt.load_model(os.path.join(folder,
                                                    tckpt.MODEL_FILENAME))
    program = texport.build_infer_fn(cfg, state_dict, device="cpu")
    example = torch.zeros((batch, 16, 16, 3), dtype=torch.uint8)
    shapes = None if low is None else (
        {0: torch.export.Dim("b", min=low, max=64)},)
    with torch.no_grad():
        ep = torch.export.export(program, (example,),
                                 dynamic_shapes=shapes)
    torch.export.save(ep, out)
    return program


def test_fixed_batch_artifact_pads(folder, tmp_path):
    out = str(tmp_path / "fixed.pt2")
    program = _fixed(folder, out)
    px = pixels(6, seed=2)
    with torch.inference_mode():
        want = {k: v.numpy()
                for k, v in program(torch.from_numpy(px)).items()}
    got = texport.predict_exported(out, px[:2], device="cpu")
    assert got["pred"].shape == (2,)
    assert_same_answers(got, {k: v[:2] for k, v in want.items()})
    with pytest.raises(ValueError, match="fixed batch"):
        texport.predict_exported(out, px, device="cpu")
    sess = InferenceSession.from_artifact(out, max_batch=8, device="cpu")
    assert sess.buckets == [4] and sess.max_batch == 4
    assert_same_answers(sess.predict(px), want)  # chunks of 4, padded


def test_batch_range_above_one_pads(folder, tmp_path):
    """An artifact whose dynamic batch starts at 2 (the 0/1
    specialisation of some torch versions) serves n = 1 padded."""
    out = str(tmp_path / "from2.pt2")
    program = _fixed(folder, out, batch=2, low=2)
    _, _, limits = texport.artifact_spec(texport.load_program(out, "cpu"))
    assert limits == (2, 64)
    px = pixels(1, seed=3)
    with torch.inference_mode():
        want = {k: v.numpy()
                for k, v in program(torch.from_numpy(px)).items()}
    assert_same_answers(texport.predict_exported(out, px, device="cpu"),
                        want)
    sess = InferenceSession.from_artifact(out, max_batch=8, device="cpu")
    assert sess.buckets == [2, 4, 8]
    assert_same_answers(sess.predict(px), want)


def test_symbolic_failure_falls_back_to_fixed_batch(folder, tmp_path,
                                                    monkeypatch, capsys):
    real = torch.export.export

    def no_dynamic(*a, dynamic_shapes=None, **kw):
        if dynamic_shapes is not None:
            raise RuntimeError("injected")
        return real(*a, **kw)

    monkeypatch.setattr(torch.export, "export", no_dynamic)
    out = str(tmp_path / "m.pt2")
    man = texport.export_model(folder, out, device="cpu")
    assert "falling back to a fixed batch of 64" in capsys.readouterr().out
    assert man["input"]["shape"][0] == 64
    assert man["batch_range"] == [64, 64]
    px = pixels(3, seed=5)
    assert_same_answers(
        texport.predict_exported(out, px, device="cpu"),
        InferenceSession.from_experiment(folder, device="cpu").predict(px))


def test_export_refusals_and_artifact_session(folder, tmp_path):
    out = str(tmp_path / "m.pt2")
    # the int8 exports themselves: tests/test_torch_quantize.py
    with pytest.raises(ValueError, match="calib_pixels"):
        texport.export_model(folder, out, quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown quantize scheme"):
        texport.export_model(folder, out, quantize="int4", device="cpu")
    with pytest.raises(ValueError, match="exported on"):
        texport.export_model(folder, out, platforms=["cuda"], device="cpu")
    texport.export_model(folder, out, platforms=["cpu"], device="cpu")
    with open(out + ".json") as f:
        manifest = json.load(f)
    manifest["platforms"] = ["cuda"]
    with open(out + ".json", "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="exported for"):
        texport.load_exported(out, device="cpu")
    manifest["platforms"] = ["cpu"]
    with open(out + ".json", "w") as f:
        json.dump(manifest, f)
    sess = InferenceSession.from_artifact(out, max_batch=4, device="cpu")
    with pytest.raises(RuntimeError, match="embedded"):
        sess.reload_weights()
    with pytest.raises(RuntimeError, match="experiment-folder"):
        start_reload_watcher(sess)
    if not torch.cuda.is_available():
        for call in (lambda: texport.export_model(folder, out),
                     lambda: texport.load_exported(out),
                     lambda: InferenceSession.from_artifact(out)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_export_normalization_from_train_config(folder, tmp_path):
    """A folder whose train_config.json asks for ImageNet normalization
    exports it, and ``--normalize-imagenet`` forces it."""
    import shutil

    norm = str(tmp_path / "norm")
    shutil.copytree(folder, norm)
    with open(os.path.join(norm, "train_config.json"), "w") as f:
        json.dump({"data": {"normalize_imagenet": True}}, f)
    out = str(tmp_path / "norm.pt2")
    assert texport.export_model(norm, out,
                                device="cpu")["normalize_imagenet"]
    px = pixels(3, seed=1)
    want = InferenceSession.from_experiment(norm, device="cpu").predict(px)
    assert_same_answers(texport.predict_exported(out, px, device="cpu"),
                        want)
    forced = str(tmp_path / "forced.pt2")
    assert texport.export_model(folder, forced, normalize_imagenet=True,
                                device="cpu")["normalize_imagenet"]
    assert_same_answers(
        texport.predict_exported(forced, px, device="cpu"), want)


def test_export_cli(folder, tmp_path, capsys):
    out = str(tmp_path / "cli.pt2")
    assert tone_bias_export.main([folder, out, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "exported" in printed and "batch=symbolic" in printed
    assert f"manifest: {out}.json" in printed
    assert tone_bias_export.main([]) == 1
    assert "Usage" in capsys.readouterr().out
    assert tone_bias_export.main(
        [folder, out, "--device", "cpu", "--quantize", "int8"]) == 1
    assert "needs --calib-root" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="keep-best"):
        tone_bias_export.main([folder, out, "--best", "--device", "cpu"])


def test_export_cli_best_flag(folder, tmp_path):
    import shutil

    best = str(tmp_path / "bexp")
    os.makedirs(best)
    shutil.copy(os.path.join(folder, tckpt.MODEL_FILENAME), best)
    other = jax_folder(tmp_path / "other", KINDS["flagship"][0], seed=7)
    shutil.copy(os.path.join(other, tckpt.MODEL_FILENAME),
                os.path.join(best, tckpt.BEST_MODEL_FILENAME))
    out = str(tmp_path / "best.pt2")
    assert tone_bias_export.main([best, out, "--best", "--device",
                                  "cpu"]) == 0
    px = pixels(2, seed=8)
    assert_same_answers(
        texport.predict_exported(out, px, device="cpu"),
        InferenceSession.from_experiment(other, device="cpu").predict(px))

"""The port's int8 post-training quantization (``serve/quantize.py``)
against the JAX package's, on the CPU, on flagship folders the JAX
package wrote: the quantized session's log-probs and fidelity report for
both calibration modes, the int8 op list (per-channel int8 kernels,
activation scales, dequant vectors) tensor for tensor, the weight-only
scheme, both int8 exports beside JAX's, the calibration rows of a
folder's splits, and the serve and export CLIs with ``--quantize``.

Tolerances: log-probs within 1e-5 (the JAX program contracts s8 x s8 in
int32, the port the same int8 values in float32, exact at these sizes;
the float epilogues differ by rounding only), activation scales and
dequant vectors within 1e-6 relative, int8 kernels exactly equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu.serve import export as jexport
from skin_image_analysis_tpu.serve import quantize as jq
from skin_image_analysis_tpu.serve import server as jserver
from skin_image_analysis_tpu.train import checkpoint as jckpt
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.bridge import (
    nhwc_flatten_permutation,
    state_dict_to_flax,
)
from skin_image_analysis_tpu_torch.cli import tone_bias_export, tone_bias_serve
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.serve import export as texport
from skin_image_analysis_tpu_torch.serve import quantize as tq
from skin_image_analysis_tpu_torch.serve import server as tserver
from skin_image_analysis_tpu_torch.serve.server import (
    InferenceSession,
    start_reload_watcher,
)
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from tests.test_torch_serve import FLAGSHIP, SIZE, pixels
from tests.test_torch_pooling import one_torch_thread  # noqa: F401

MODES = ("max", "percentile:99")
ATOL = 1e-5
RTOL_SCALE = 1e-6


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_written_folder(folder, seed: int) -> str:
    """A flagship experiment folder the JAX package's ``save_model``
    wrote, of weights from the port's seeded init (no JAX init to
    compile)."""
    os.makedirs(folder)
    model = build_model(tconfig.ModelConfig(**FLAGSHIP), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    jckpt.save_model(os.path.join(folder, jckpt.MODEL_FILENAME),
                     jconfig.ModelConfig(**FLAGSHIP),
                     state_dict_to_flax(model.state_dict(), SIZE), None)
    return str(folder)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return jax_written_folder(tmp_path_factory.mktemp("quant") / "flagship",
                              seed=1)


@pytest.fixture(scope="module")
def calib():
    return pixels(24, seed=1)


@pytest.fixture(scope="module")
def evalpx():
    return pixels(8, seed=2)


@pytest.fixture(scope="module")
def checkpoints(folder):
    jcfg, loaded = jckpt.load_model(os.path.join(folder,
                                                 jckpt.MODEL_FILENAME))
    params, _ = jckpt.split_variables(loaded)
    tcfg, sd = tckpt.load_model(os.path.join(folder, tckpt.MODEL_FILENAME))
    return jcfg, params, tcfg, sd


_JAX_TREES: dict = {}


@pytest.fixture(scope="module")
def sessions(folder, calib):
    """mode -> (the JAX int8 session, the port's) of one folder; the JAX
    session's quantized tree is kept in ``_JAX_TREES``."""
    real = jq.quantize_model

    def keep(*a, **kw):
        tree = real(*a, **kw)
        _JAX_TREES[tree["calib_mode"]] = tree
        return tree

    mp = pytest.MonkeyPatch()
    mp.setattr(jq, "quantize_model", keep)
    try:
        return {mode: (
            jserver.InferenceSession.from_experiment_quantized(
                folder, calib, max_batch=8, calib_mode=mode),
            InferenceSession.from_experiment_quantized(
                folder, calib, max_batch=8, calib_mode=mode, device="cpu"))
            for mode in MODES}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_trees(sessions):
    """mode -> the JAX package's quantized tree behind its session."""
    return _JAX_TREES


def assert_reports_match(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in ("agreement", "agreement_confident", "confident_fraction",
                "n"):
        assert got[key] == want[key], key
    assert got["mean_abs_dlogp"] == pytest.approx(want["mean_abs_dlogp"],
                                                  rel=1e-4, abs=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_quantized_session_matches_jax(sessions, checkpoints, jax_trees,
                                       evalpx, mode):
    js, ts = sessions[mode]
    want, got = js.predict(evalpx), ts.predict(evalpx)
    np.testing.assert_allclose(got["log_probs"], want["log_probs"],
                               atol=ATOL)
    np.testing.assert_array_equal(got["pred"], want["pred"])
    np.testing.assert_allclose(got["p_malignant"], want["p_malignant"],
                               atol=ATOL)
    jcfg, params, tcfg, sd = checkpoints
    assert ts.qtree["calib_mode"] == mode
    assert_reports_match(
        tq.quantization_report(tcfg, sd, ts.qtree, evalpx, device="cpu"),
        jq.quantization_report(jcfg, params, jax_trees[mode], evalpx))


def _contractions(ops):
    return [op for op in ops if op["op"] in ("conv", "dense")]


@pytest.mark.parametrize("mode", MODES)
def test_int8_op_list_matches_jax(sessions, jax_trees, mode):
    """The int8 kernels, their input scales and dequant vectors, and the
    activations' requantize scales, in order."""
    ts, jtree = sessions[mode][1], jax_trees[mode]
    jc, tc = _contractions(jtree["ops"]), _contractions(ts.qtree["ops"])
    assert [(o["op"], o["quantize"]) for o in tc] == \
        [(o["op"], o["quantize"]) for o in jc]
    first_dense = next(i for i, o in enumerate(jc) if o["op"] == "dense")
    for i, (j, t) in enumerate(zip(jc, tc)):
        kq = np.asarray(j["kernel_q"])
        deq = t["dequant"].reshape(-1).numpy()
        if j["op"] == "conv":
            kq = kq.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        elif i == first_dense:
            # JAX flattens NHWC (h, w, c), the port NCHW (c, h, w)
            c = jc[first_dense - 1]["kernel_q"].shape[-1]
            side = int(np.sqrt(kq.shape[0] // c))
            rows = np.empty_like(kq)
            rows[nhwc_flatten_permutation(c, side, side)] = kq
            kq = rows
        np.testing.assert_array_equal(t["kernel_q"].numpy(), kq)
        assert t["in_scale"] == pytest.approx(j["in_scale"], rel=RTOL_SCALE)
        np.testing.assert_allclose(deq, np.asarray(j["dequant"]),
                                   rtol=RTOL_SCALE)
    ja = [o["out_scale"] for o in jtree["ops"] if o["op"] == "act"]
    ta = [o["out_scale"] for o in ts.qtree["ops"] if o["op"] == "act"]
    assert [s is None for s in ta] == [s is None for s in ja]
    assert [s for s in ta if s is not None] == pytest.approx(
        [s for s in ja if s is not None], rel=RTOL_SCALE)


def test_parse_calib_mode_matches_jax():
    for mode in ("max", "percentile", "percentile:99.5", "percentile:100"):
        assert tq.parse_calib_mode(mode) == jq.parse_calib_mode(mode)
    for bad in ("min", "percentile:50", "percentile:101"):
        with pytest.raises(ValueError):
            jq.parse_calib_mode(bad)
        with pytest.raises(ValueError):
            tq.parse_calib_mode(bad)


def test_weights_only_matches_jax(checkpoints, evalpx):
    jcfg, params, tcfg, sd = checkpoints
    jw = jq.quantize_weights_only(params)
    tw = tq.quantize_weights_only(sd)
    for i in range(len(FLAGSHIP["conv_features"])):
        j = jw["ConvBlock_%d" % i]["Conv_0"]
        t = tw[f"conv_blocks.{i}.weight"]
        np.testing.assert_array_equal(
            t["_w8"].numpy(), j["kernel"]["_w8"].transpose(3, 2, 0, 1))
        np.testing.assert_allclose(t["_scale"].numpy(), j["kernel"]["_scale"],
                                   rtol=RTOL_SCALE)
        assert tw[f"conv_blocks.{i}.bias"].dtype == torch.float32
    head = tw["head.weight"]
    np.testing.assert_array_equal(head["_w8"].numpy(),
                                  jw["Dense_0"]["kernel"]["_w8"].T)
    assert_reports_match(
        tq.weights_only_report(tcfg, sd, tw, evalpx, device="cpu"),
        jq.weights_only_report(jcfg, params, jw, evalpx))


@pytest.mark.parametrize("scheme", ("int8", "int8-weights"))
def test_int8_exports_match_jax(folder, calib, evalpx, tmp_path, scheme):
    """Both int8 artifacts beside JAX's: the manifests' quantization
    entries, and the answers of each artifact."""
    kw = dict(quantize=scheme, report_pixels=evalpx,
              calib_pixels=calib if scheme == "int8" else None)
    tman = texport.export_model(folder, str(tmp_path / "t.pt2"),
                                device="cpu", **kw)
    jman = jexport.export_model(folder, str(tmp_path / "j.shlo"),
                                platforms=["cpu"], **kw)
    tquant, jquant = tman["quantization"], jman["quantization"]
    assert set(tquant) == set(jquant)
    assert tquant["scheme"] == jquant["scheme"] == scheme
    assert tquant.get("calib_mode") == jquant.get("calib_mode")
    assert_reports_match({k: v for k, v in tquant.items()
                          if k not in ("scheme", "calib_mode")},
                         {k: v for k, v in jquant.items()
                          if k not in ("scheme", "calib_mode")})
    assert tman["input"]["shape"][0] == "symbolic"
    px = pixels(5, seed=9)
    got = texport.predict_exported(str(tmp_path / "t.pt2"), px,
                                   device="cpu")
    want = jexport.predict_exported(str(tmp_path / "j.shlo"), px)
    np.testing.assert_allclose(got["log_probs"], want["log_probs"],
                               atol=ATOL)
    np.testing.assert_array_equal(got["pred"], want["pred"])
    # the artifact ships int8 weights
    ep = texport.load_program(str(tmp_path / "t.pt2"), "cpu")
    dtypes = {str(v.dtype) for v in list(ep.state_dict.values())
              + list(ep.constants.values())}
    assert "torch.int8" in dtypes


def test_quantized_session_does_not_reload_and_wants_the_card(sessions):
    ts = sessions["max"][1]
    with pytest.raises(RuntimeError, match="int8-quantized session"):
        ts.reload_weights()
    with pytest.raises(RuntimeError, match="experiment-folder"):
        start_reload_watcher(ts)
    if not torch.cuda.is_available():
        cfg, sd = tckpt.load_model(os.path.join(ts.source,
                                                tckpt.MODEL_FILENAME))
        for call in (
                lambda: InferenceSession.from_experiment_quantized(
                    ts.source, pixels(2)),
                lambda: tq.quantize_model(cfg, sd, pixels(2)),
                lambda: tq.build_infer_fn_quantized(ts.qtree),
                lambda: tq.quantization_report(cfg, sd, ts.qtree,
                                               pixels(2)),
                lambda: tq.build_infer_fn_w8(
                    cfg, tq.quantize_weights_only(sd))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


@pytest.fixture(scope="module")
def split_folder(folder, tmp_path_factory):
    """``folder`` with session_train.csv and session_test.csv over a
    synthetic JPEG cohort at the model's size."""
    import shutil

    from tests.fixtures import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("quant_root"))
    rows = make_synthetic_dataset(root, n=20, seed=4, image_size=SIZE)
    out = str(tmp_path_factory.mktemp("quant_split") / "exp")
    shutil.copytree(folder, out)
    for name, part in (("session_train.csv", rows[:12]),
                       ("session_test.csv", rows[12:])):
        with open(os.path.join(out, name), "w") as f:
            f.write(",isic_id,benign_malignant\n")
            for i, r in enumerate(part):
                f.write(f"{i},{r['isic_id']},benign\n")
    return out, root


def test_calibration_rows_and_clis(split_folder, tmp_path, capsys,
                                   monkeypatch):
    folder, root = split_folder
    calib, report, on_calib = tq.calibration_rows(folder, root, 8)
    assert calib.shape == (8, SIZE, SIZE, 3) and calib.dtype == np.uint8
    assert report.shape == (8, SIZE, SIZE, 3) and not on_calib
    _, only, _ = tq.calibration_rows(folder, root, 8, report_only=True)
    np.testing.assert_array_equal(only, report)

    out = str(tmp_path / "q.pt2")
    assert tone_bias_export.main(
        [folder, out, "--quantize", "int8", "--calib-root", root,
         "--calib-rows", "8", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "quantization: {'scheme': 'int8'" in printed
    with open(out + ".json") as f:
        quant = json.load(f)["quantization"]
    assert quant["calib_mode"] == "max" and quant["n"] == 8
    want = InferenceSession.from_experiment_quantized(
        folder, calib, device="cpu").predict(report)
    got = texport.predict_exported(out, report, device="cpu")
    np.testing.assert_allclose(got["log_probs"], want["log_probs"],
                               atol=ATOL)

    served = {}
    monkeypatch.setattr(tserver, "serve_http", lambda batcher, **kw:
                        served.update(session=batcher.session))
    assert tone_bias_serve.main(
        [folder, "--quantize", "int8", "--calib-root", root,
         "--calib-rows", "8", "--no-warm", "--device", "cpu"]) == 0
    sess = served["session"]
    assert sess.qtree["calib_mode"] == "max"
    np.testing.assert_allclose(sess.predict(report)["log_probs"],
                               want["log_probs"], atol=ATOL)

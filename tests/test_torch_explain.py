"""The port's explainability path against the JAX package's on the CPU, on
the same inputs (numpy, from a seed) and the same weights (carried across
by ``bridge``): IG, saliency, SmoothGrad and GradientShap (noise off),
occlusion and both Grad-CAMs on the JAX package's own test model (conv
4/8, MLP 16, 16²) and resnet18 at 32²; the Keras-compatible families'
Grad-CAM against a reference built from the JAX model's captured feature
map (JAX's own rule finds no map there, or the wrong one); the CLI's
bilinear upsampling against ``jax.image.resize``; the figures; and both
packages' explain CLIs and the port's test CLI ``--grid`` on one tiny
folder. Each test states its tolerance."""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from skin_image_analysis_tpu import explain as jexplain
from skin_image_analysis_tpu.config import ModelConfig as JModelConfig
from skin_image_analysis_tpu.data import read_isic_metadata
from skin_image_analysis_tpu.explain import viz as jviz
from skin_image_analysis_tpu.explain.attribution import (
    _flatten_intermediates,
)
from skin_image_analysis_tpu.models import cnn as jcnn
from skin_image_analysis_tpu.models import xception as jxception
from skin_image_analysis_tpu.train import checkpoint as jckpt
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch import explain as texplain
from skin_image_analysis_tpu_torch.cli import tone_bias_explain as texplain_cli
from skin_image_analysis_tpu_torch.cli import tone_bias_test as ttest_cli
from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.explain import attribution as tattr
from skin_image_analysis_tpu_torch.explain import viz as tviz
from skin_image_analysis_tpu_torch.explain.attribution import (
    gap_head_log_probs,
)
from skin_image_analysis_tpu_torch.models import xception as txception
from skin_image_analysis_tpu_torch.models.cnn import build_model
from tests.fixtures import make_synthetic_dataset
from tests.test_torch_cli import _jax_one_device
from tests.test_torch_efficientnet import PAIR as EFFICIENTNET
from tests.test_torch_efficientnet_v2 import PAIR as EFFICIENTNET_V2
from tests.test_torch_families import (
    Pair,
    jax_variables,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    port_model,
)
from tests.test_torch_resnet import _np
from tests.test_torch_resnet import jax_variables as resnet_variables
from tests.test_torch_resnet import port_model as resnet_port_model
from tests.test_torch_resnet_v2 import PAIR as RESNET_V2
from tests.test_torch_vgg_mobilenet import PAIRS

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the JAX package's own explain test model (tests/test_explain.py)
CFG = dict(conv_features=(4, 8), linear_features=(16,), dropout=(0.2,),
           image_size=16, compute_dtype="float32")
B = 2
# float32 on both sides: the same ops up to summation order; the
# gradients' elements are of order 1e-3 to 1e-1
RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def flagship():
    """(JAX model, params as numpy, the port's model on them)."""
    jm = jcnn.build_model(JModelConfig(**CFG))
    params = _np(jax.jit(lambda k: jm.init(k, jnp.zeros((1, 16, 16, 3)),
                                           train=False))(
        jax.random.key(0))["params"])
    tm = build_model(ModelConfig(**CFG), device="cpu")
    tm.load_state_dict(bridge.variables_to_state_dict(params, None, 16))
    return jm, params, tm


def inputs(seed, side=16, b=B):
    rng = np.random.default_rng(seed)
    x = rng.random((b, side, side, 3), dtype=np.float32)
    target = rng.integers(0, 2, b).astype(np.int32)
    return x, target


def both(x, target):
    return ((jnp.asarray(x), jnp.asarray(target)),
            (torch.from_numpy(x), torch.from_numpy(target).long()))


# -- the gradient methods --------------------------------------------------

@pytest.mark.parametrize("n_steps,rows", [(8, 256), (32, 256), (32, 6)])
def test_integrated_gradients_matches_jax(flagship, n_steps, rows,
                                          monkeypatch):
    """At ``rows`` 6 each pass holds 3 of the 32 steps (11 passes)."""
    monkeypatch.setattr(tattr, "ROWS_PER_PASS", rows)
    jm, params, tm = flagship
    (jx, jt), (tx, tt) = both(*inputs(1))
    want = jexplain.integrated_gradients(jm.apply, params, jx, jt,
                                         n_steps=n_steps)
    got = texplain.integrated_gradients(tm, tx, tt, n_steps=n_steps)
    assert got.shape == tx.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_saliency_matches_jax(flagship):
    jm, params, tm = flagship
    (jx, jt), (tx, tt) = both(*inputs(2, b=3))
    want = jexplain.saliency(jm.apply, params, jx, jt)
    got = texplain.saliency(tm, tx, tt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_smoothgrad_without_noise_matches_jax(flagship):
    """sigma 0: every sample is the saliency of x."""
    jm, params, tm = flagship
    (jx, jt), (tx, tt) = both(*inputs(3))
    want = jexplain.smoothgrad(jm.apply, params, jx, jt, jax.random.key(4),
                               n_samples=3, sigma=0.0)
    got = texplain.smoothgrad(tm, tx, tt, torch.Generator().manual_seed(4),
                              n_samples=3, sigma=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_gradient_shap_without_noise_matches_jax(flagship):
    """sigma 0 and explicit baselines: the mean of IG from each."""
    jm, params, tm = flagship
    (jx, jt), (tx, tt) = both(*inputs(5))
    base = np.random.default_rng(6).random((3, 16, 16, 3), dtype=np.float32)
    want = jexplain.gradient_shap(jm.apply, params, jx, jt,
                                  jax.random.key(7), jnp.asarray(base),
                                  n_steps=8, sigma=0.0)
    got = texplain.gradient_shap(tm, tx, tt, torch.Generator().manual_seed(7),
                                 torch.from_numpy(base), n_steps=8, sigma=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("method", ["smoothgrad", "gradient_shap"])
def test_noisy_methods_follow_their_generator(flagship, method):
    """sigma > 0 (and default baselines): finite, of x's shape, the same
    for the same generator seed and not for another. The draws are the
    torch generator's, so the bits are not JAX's."""
    _, _, tm = flagship
    _, (tx, tt) = both(*inputs(8))
    kw = (dict(n_samples=4) if method == "smoothgrad"
          else dict(n_baselines=3, n_steps=4))
    fn = getattr(texplain, method)

    def run(seed):
        return fn(tm, tx, tt, torch.Generator().manual_seed(seed), **kw)

    a, again, other = run(0), run(0), run(1)
    assert a.shape == tx.shape and torch.isfinite(a).all()
    assert a.abs().sum() > 0
    assert torch.equal(a, again) and not torch.allclose(a, other)


@pytest.mark.parametrize("rows", [256, 4])
def test_occlusion_matches_jax(flagship, rows, monkeypatch):
    """Patch 4, stride 2 on 16²: a 7x7 grid; at ``rows`` 4, 2 positions a
    pass. Score drops within 1e-5 (log-probs of order 1)."""
    monkeypatch.setattr(tattr, "ROWS_PER_PASS", rows)
    jm, params, tm = flagship
    (jx, jt), (tx, tt) = both(*inputs(9))
    want = jexplain.occlusion_map(jm.apply, params, jx, jt, patch_size=4,
                                  stride=2)
    got = texplain.occlusion_map(tm, tx, tt, patch_size=4, stride=2)
    assert got.shape == (B, 7, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# -- Grad-CAM ----------------------------------------------------------------

@pytest.mark.parametrize("layer", [None, "ConvBlock_0/__call__"])
def test_grad_cam_matches_jax(flagship, layer):
    """The CAM in [0, 1] within 1e-5 of JAX's, on the last block (4x4)
    and on block 0 (8x8)."""
    jm, params, tm = flagship
    (jx, jt), (tx, tt) = both(*inputs(10))
    want = np.asarray(jexplain.grad_cam(jm, params, jx, jt, layer))
    got = texplain.grad_cam(tm, tx, tt, layer)
    assert got.shape == want.shape == ((B, 4, 4) if layer is None
                                       else (B, 8, 8))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_grad_cam_refuses_unknown_layers_and_gap_head_the_flagship(
        flagship):
    _, _, tm = flagship
    _, (tx, tt) = both(*inputs(11))
    for bad in ("ConvBlock_2/__call__", "Dense_0", "ConvBlock_0"):
        with pytest.raises(ValueError, match="no conv block"):
            texplain.grad_cam(tm, tx, tt, bad)
    with pytest.raises(TypeError, match="use grad_cam"):
        texplain.grad_cam_gap_head(tm, tx, tt)


def test_grad_cam_gap_head_matches_jax_on_resnet18():
    """JAX's rule finds ``BasicBlock_7``, the map the GAP reads: the CAMs
    within 1e-5."""
    jm, params, stats = resnet_variables("resnet18")
    tm = resnet_port_model("resnet18", params, stats)
    (jx, jt), (tx, tt) = both(*inputs(12, side=64))
    want = np.asarray(jexplain.grad_cam_gap_head(
        jm, {"params": params, "batch_stats": stats}, jx, jt))
    got = texplain.grad_cam_gap_head(tm, tx, tt)
    assert got.shape == want.shape == (B, 2, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _relu(a):
    return jax.nn.relu(a)


# Each Keras-compatible family at reduced depth (the family tests'
# modules): the JAX module whose output the GAP's map is made from, and
# how (the family's activation; VGG's last pool).
KERAS = {
    "xception_small": (
        Pair("xception_small",
             lambda dt: jxception.Xception(middle_blocks=2, head_dropout=0.0,
                                           compute_dtype=dt),
             lambda dt: txception.Xception(middle_blocks=2, head_dropout=0.0,
                                           compute_dtype=dt)),
        "block8_sepconv2_bn", _relu),
    "vgg16": (PAIRS["vgg"], "block5_conv1",
              lambda a: fnn.max_pool(_relu(a), (2, 2), strides=(2, 2))),
    "resnet50_v2": (RESNET_V2, "post_bn", _relu),
    "mobilenet_v2": (PAIRS["mobilenet_v2"], "Conv_1_bn", jax.nn.relu6),
    "efficientnet_b0": (EFFICIENTNET, "top_bn", jax.nn.silu),
    "efficientnet_v2_s": (EFFICIENTNET_V2, "top_bn", jax.nn.silu),
}


@pytest.fixture(scope="module")
def keras_variables():
    cache = {}

    def get(family):
        if family not in cache:
            cache[family] = jax_variables(KERAS[family][0])
        return cache[family]

    return get


def jax_gap_cam(act, head, target):
    """The JAX package's closed-form GAP head and CAM formula
    (``attribution._gap_head_cam``) on a given NHWC map."""
    w = jnp.asarray(head["kernel"], jnp.float32)
    b = jnp.asarray(head["bias"], jnp.float32)

    def score(a):
        logits = jnp.mean(a.astype(jnp.float32), axis=(1, 2)) @ w + b
        lp = jax.nn.log_softmax(logits, axis=-1)
        return jnp.sum(jnp.take_along_axis(lp, target[:, None], -1))

    grads = jax.grad(score)(act)
    weights = jnp.mean(grads, axis=(1, 2), keepdims=True)
    cam = jnp.maximum(jnp.sum(weights * act.astype(jnp.float32), -1), 0.0)
    mx = jnp.max(cam.reshape(cam.shape[0], -1), axis=1)
    return np.asarray(cam / jnp.maximum(mx[:, None, None], 1e-12))


@pytest.mark.parametrize("family", list(KERAS))
def test_keras_family_grad_cam_matches_the_reference(family,
                                                     keras_variables):
    """At 64² (a 2x2 map; at 32² it is 1x1): the port's feature map within
    1e-4 of the JAX model's captured module output through the family's
    activation, the head on it giving back the model's log-probs within
    1e-5, and the CAM within 1e-5 of JAX's formula on that map."""
    pair, key, act_fn = KERAS[family]
    params, stats = keras_variables(family)
    tm = port_model(pair, params, stats)
    (jx, jt), (tx, tt) = both(*inputs(13, side=64))
    jm = pair.jax("float32")
    variables = {"params": params, **({"batch_stats": stats} if stats
                                      else {})}
    _, inter = jax.jit(lambda v, a: jm.apply(
        v, a, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, name: name == "__call__"))(
            variables, jx)
    act = act_fn(_flatten_intermediates(inter["intermediates"])
                 [f"{key}/__call__"])
    with torch.no_grad():
        feats = tm.features(tx)
        head = gap_head_log_probs(tm, feats)
        log_probs = tm(tx)
    np.testing.assert_allclose(feats.permute(0, 2, 3, 1).numpy(),
                               np.asarray(act), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(head.numpy(), log_probs.numpy(), atol=1e-5,
                               rtol=0)
    want = jax_gap_cam(act, params["Dense_0"], jt)
    got = texplain.grad_cam_gap_head(tm, tx, tt)
    assert got.shape == want.shape == (B, 2, 2)
    assert (got >= 0).all() and (got <= 1).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_head_gives_back_the_log_probs(name):
    _, params, stats = resnet_variables(name)
    tm = resnet_port_model(name, params, stats)
    _, (tx, _) = both(*inputs(14, side=32))
    with torch.no_grad():
        np.testing.assert_allclose(
            gap_head_log_probs(tm, tm.features(tx)).numpy(),
            tm(tx).numpy(), atol=1e-5, rtol=0)


# -- the CLI's upsampling and the figures ---------------------------------

@pytest.mark.parametrize("small,large", [(7, 224), (13, 224), (2, 32),
                                         (3, 37), (5, 64)])
def test_upsample_matches_jax_image_resize(small, large):
    """Within 1e-6 of ``jax.image.resize(..., "bilinear")``."""
    maps = np.random.default_rng(small).random((2, small, small),
                                               dtype=np.float32)
    want = jax.image.resize(jnp.asarray(maps)[..., None],
                            (2, large, large, 1), method="bilinear")
    got = texplain_cli.upsample(torch.from_numpy(maps), large, large)
    assert got.shape == (2, large, large, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_attr_to_heat_equals_jax():
    attr = np.random.default_rng(0).normal(size=(16, 16, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(tviz._attr_to_heat(attr),
                                  jviz._attr_to_heat(attr))


def test_figures_write_files_and_name_matplotlib_when_missing(tmp_path,
                                                              monkeypatch):
    rng = np.random.default_rng(1)
    img = rng.random((16, 16, 3), dtype=np.float32)
    attr = rng.normal(size=(16, 16, 3)).astype(np.float32)
    trip, grid = str(tmp_path / "trip.png"), str(tmp_path / "grid.png")
    tviz.visualize_attribution_triptych(img, attr, title="t", save_path=trip)
    tviz.visualize_predictions_grid(np.stack([img] * 4), ["a", "b"] * 2,
                                    ["a"] * 4, save_path=grid)
    assert os.path.getsize(trip) > 0 and os.path.getsize(grid) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tviz.visualize_attribution_triptych(img, attr)
    with pytest.raises(ImportError, match="matplotlib"):
        tviz.visualize_predictions_grid(img[None], ["a"], ["a"])


# -- the CLIs on one cohort ----------------------------------------------

@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A cohort of 32² JPEGs and experiment folders both packages read,
    each with the first 4 rows as ``session_test.csv``: the JAX test model
    (``flagship``), and resnet18 with its ``batch_stats`` and an
    ImageNet-normalized input (``resnet18``). Returns (root, folders)."""
    base = tmp_path_factory.mktemp("explain")
    root = str(base / "cohort")
    make_synthetic_dataset(root, n=12, seed=3, image_size=32)
    rows = read_isic_metadata(root, seed=0).head(4)
    folders = {name: str(base / name) for name in ("flagship", "resnet18")}
    for path in folders.values():
        os.makedirs(path)
        rows.to_csv(os.path.join(path, "session_test.csv"))
    jm = jcnn.build_model(JModelConfig(**CFG))
    params = jm.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                     train=False)["params"]
    jckpt.save_model(os.path.join(folders["flagship"], jckpt.MODEL_FILENAME),
                     JModelConfig(**CFG), params)
    _, params, stats = resnet_variables("resnet18")
    jckpt.save_model(os.path.join(folders["resnet18"], jckpt.MODEL_FILENAME),
                     JModelConfig(name="resnet18", image_size=32,
                                  compute_dtype="float32"), params, stats)
    with open(os.path.join(folders["resnet18"], "train_config.json"),
              "w") as f:
        f.write('{"data": {"normalize_imagenet": true}}')
    return root, folders


def _run_cli(main, viz_module, root, folder, argv, monkeypatch, capsys):
    """main(argv) on a copy of ``folder``: (its explain/ file names, the
    attributions it drew, its --bench record). ``viz_module`` is where
    ``main`` looks ``visualize_attribution_triptych`` up."""
    import json

    work = folder + f"_{len(os.listdir(os.path.dirname(folder)))}"
    shutil.copytree(folder, work)
    drawn = []
    draw = viz_module.visualize_attribution_triptych

    def record(image, attribution, **kw):
        drawn.append(np.asarray(attribution))
        return draw(image, attribution, **kw)

    monkeypatch.setattr(viz_module, "visualize_attribution_triptych", record)
    capsys.readouterr()
    assert main([root, work, *argv]) == 0
    out = capsys.readouterr().out
    bench = json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("{")))
    return sorted(os.listdir(os.path.join(work, "explain"))), \
        np.stack(drawn), bench


@pytest.mark.parametrize("model,method", [
    *(("flagship", m) for m in texplain_cli.METHODS),
    ("resnet18", "saliency"), ("resnet18", "gradcam")])
def test_explain_clis_agree(folder, model, method, monkeypatch, capsys):
    """Both CLIs with ``--bench`` on the same 4-row folder: the same
    files, the same bench keys, and the same attributions (IG at 8 steps)
    within 1e-5 (and 1e-4 relative) of each other; SmoothGrad's and
    GradientShap's draws differ between the packages, so theirs are
    compared by shape. resnet18 runs on ImageNet-normalized input, its
    Grad-CAM on the GAP head in both packages."""
    from skin_image_analysis_tpu.cli import tone_bias_explain as jcli

    root, folders = folder
    path = folders[model]
    argv = ["--method", method, "--steps", "8", "--bench"]
    with _jax_one_device():
        jfiles, jattr, jbench = _run_cli(jcli.main, jviz, root, path, argv,
                                         monkeypatch, capsys)
    tfiles, tattr_, tbench = _run_cli(
        texplain_cli.main, texplain_cli, root, path,
        [*argv, "--device", "cpu"], monkeypatch, capsys)
    assert tfiles == jfiles and len(tfiles) == 4
    assert tfiles[0].startswith(f"{method}_")
    assert set(tbench) == set(jbench)
    same = ("method", "steps", "image_size", "model")
    assert {k: tbench[k] for k in same} == {k: jbench[k] for k in same}
    # JAX's n_images is the flag's 6, the port's the rows attributed
    assert tbench["n_images"] == 4 and tbench["s_per_batch"] > 0
    assert tattr_.shape == jattr.shape and np.isfinite(tattr_).all()
    if method not in ("smoothgrad", "gradientshap"):
        np.testing.assert_allclose(tattr_, jattr, atol=1e-5, rtol=1e-4)


def test_explain_returns_what_the_figures_draw(folder):
    """The split-out attribution step: [0, 1] images, attributions,
    predictions and probabilities of the first rows."""
    root, folders = folder
    out = texplain_cli.explain(root, folders["flagship"], "saliency",
                               n_images=3, device="cpu")
    assert out.images.shape == (3, 16, 16, 3) == out.attributions.shape
    assert out.images.min() >= 0 and out.images.max() <= 1
    assert out.preds.shape == (3,) and out.probs.shape == (3, 2)
    np.testing.assert_allclose(out.probs.sum(1), 1, atol=1e-6)
    assert out.bench is None and len(out.table) == 3


def test_test_cli_grid_writes_its_figure(folder, tmp_path, capsys):
    root, folders = folder
    grid = str(tmp_path / "grid.png")
    assert ttest_cli.main([root, folders["flagship"], "--grid", grid,
                           "--device", "cpu"]) == 0
    assert os.path.getsize(grid) > 0
    assert f"wrote {grid}" in capsys.readouterr().out


def test_cli_grad_cam_takes_grad_cam_for_the_flagships_and_the_gap_head_else():
    """The legacy ``skin_cancer`` model (which the JAX CLI sends down the
    GAP-head path, where it has no GAP) takes ``grad_cam`` on its own
    blocks; resnet18 takes ``grad_cam_gap_head``; both upsampled to the
    input's size."""
    legacy = build_model(ModelConfig(name="skin_cancer", image_size=32,
                                     compute_dtype="float32"), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    _, params, stats = resnet_variables("resnet18")
    resnet = resnet_port_model("resnet18", params, stats)
    _, (tx, tt) = both(*inputs(15, side=32))
    for model, cam_fn, side in ((legacy, texplain.grad_cam, 2),
                                (resnet, texplain.grad_cam_gap_head, 1)):
        cam = cam_fn(model, tx, tt)
        assert cam.shape == (B, side, side)
        got = texplain_cli.attribute(model, tx, tt, "gradcam")
        assert torch.equal(got, texplain_cli.upsample(cam, 32, 32))

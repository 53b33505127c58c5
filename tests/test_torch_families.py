"""The port's Keras-compatible transfer families (VGG, ResNet-V2,
MobileNetV2, EfficientNet, EfficientNetV2) against the JAX package's, on
the CPU: every registered name's full-size ``state_dict`` against
``jax.eval_shape`` of the JAX init through the bridge, the stochastic-depth
rates block by block, the per-sample drop mask, and the registry.

It also holds the parity harness that the family files
(``test_torch_vgg_mobilenet.py``, ``test_torch_resnet_v2.py``,
``test_torch_efficientnet.py``, ``test_torch_efficientnet_v2.py``) run on
reduced-depth modules of both packages: the float32 eval forward, one
train-mode step with batch statistics, the bf16 gradient, the bridge, the
``.h5`` loaders and ``session_model.msgpack``."""

import dataclasses
import sys
from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from skin_image_analysis_tpu.config import ModelConfig as JModelConfig
from skin_image_analysis_tpu.models import cnn as jcnn
from skin_image_analysis_tpu.models import registry as jregistry
from skin_image_analysis_tpu.train import checkpoint as jckpt
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models import efficientnet as teff
from skin_image_analysis_tpu_torch.models import registry as tregistry
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.models.resnet import BatchNorm, Conv
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from tests.test_torch_pooling import one_torch_thread  # noqa: F401
from tests.test_torch_resnet import _cos, _leaves, _np, perturb
from tests.test_torch_xception import _write_h5

SIDE, B = 32, 8

KERAS_FAMILIES = (
    "resnet50_v2", "resnet101_v2", "resnet152_v2", "vgg16", "vgg19",
    "mobilenet_v2", *(f"efficientnet_b{i}" for i in range(8)),
    *(f"efficientnet_v2_{v}" for v in ("b0", "b1", "b2", "b3", "s", "m",
                                       "l")),
)


# -- the parity harness ---------------------------------------------------

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class Pair(NamedTuple):
    """One family at reduced depth in both packages: ``jax(dtype)`` and
    ``port(dtype)`` build the same module (head dropout and stochastic
    depth off), ``name`` is the registered name its checkpoints carry."""
    name: str
    jax: Callable
    port: Callable


def jax_variables(pair: Pair, seed: int = 0):
    """(params, batch_stats) of a jitted JAX init, with random BatchNorm
    scales, biases and statistics and random conv biases
    (``test_torch_resnet.perturb``), as numpy trees no test changes;
    ``batch_stats`` is ``{}`` for VGG."""
    model = pair.jax("float32")
    v = jax.jit(lambda k: model.init({"params": k},
                                     jnp.zeros((1, SIDE, SIDE, 3)),
                                     train=False))(jax.random.key(seed))
    return perturb(_np(v["params"]), _np(v.get("batch_stats", {})), seed)


def scaled_bns(params, names, scale=0.2):
    """``params`` with the BatchNorms whose module name is in ``names``
    (at any depth) scaled by ``scale``."""
    if "scale" in params:
        return params
    return {k: ({**v, "scale": v["scale"] * np.float32(scale)}
                if k in names else scaled_bns(v, names, scale))
            if isinstance(v, dict) else v for k, v in params.items()}


def _variables(params, stats):
    return {"params": params, **({"batch_stats": stats} if stats else {})}


def port_model(pair: Pair, params, stats, compute_dtype="float32"):
    model = pair.port(compute_dtype)
    model.load_state_dict(bridge.variables_to_state_dict(params, stats, SIDE))
    return model


def batch(seed, side=SIDE, b=B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, side, side, 3)).astype(np.float32)
    return x, np.arange(b, dtype=np.int32) % 2


def check_forward(pair: Pair, params, stats, side: int) -> None:
    """float32 eval log-probs within 2e-5 of JAX's; the parameter and
    buffer counts equal."""
    model = port_model(pair, params, stats)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in _leaves(params))
    assert sum(b.numel() for b in model.buffers()) == \
        sum(x.size for x in _leaves(stats))
    x, _ = batch(side, side)
    jm = pair.jax("float32")
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        _variables(params, stats), jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def train_grads(pair: Pair, compute_dtype, params, stats, seed=2,
                side=SIDE, b=B):
    """Both packages' train-mode mean NLL, its gradient (leaf lists in
    Flax order) and the moved batch statistics (leaf lists)."""
    x, labels = batch(seed, side, b)
    jm = pair.jax(compute_dtype)

    def loss(p):
        lp, upd = jm.apply(_variables(p, stats), jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
        nll = -jnp.mean(jnp.take_along_axis(
            lp, jnp.asarray(labels)[:, None], axis=-1))
        return nll, upd.get("batch_stats", {})

    (j_loss, j_stats), j_grad = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree.map(jnp.asarray, params))
    tm = port_model(pair, params, stats, compute_dtype)
    lp = tm(torch.from_numpy(x), train=True,
            generator=torch.Generator().manual_seed(0))
    t_loss = -lp.gather(1, torch.from_numpy(labels).long()[:, None]).mean()
    t_loss.backward()
    buffers = dict(tm.named_buffers())
    t_grad, _ = bridge.state_dict_to_variables(
        {**{k: p.grad for k, p in tm.named_parameters()}, **buffers}, SIDE)
    _, t_stats = bridge.state_dict_to_variables(tm.state_dict(), SIDE)
    return {"loss": (float(j_loss), float(t_loss.detach())),
            "grad": (_leaves(j_grad), _leaves(t_grad)),
            "stats": (_leaves(j_stats), _leaves(t_stats or {}))}


def check_train_step(pair: Pair, params, stats, b: int = B) -> None:
    """float32 train mode over a batch of ``b``: the loss within 5e-6, each
    gradient leaf within 1e-5 + 1e-4 relative, each moved running
    statistic within 1e-6."""
    out = train_grads(pair, "float32", params, stats, b=b)
    j_loss, t_loss = out["loss"]
    assert abs(j_loss - t_loss) <= 5e-6
    j_grad, t_grad = out["grad"]
    assert len(j_grad) == len(t_grad) == len(_leaves(params))
    for a, g in zip(t_grad, j_grad):
        np.testing.assert_allclose(a, g, atol=1e-5, rtol=1e-4)
    j_stats, t_stats = out["stats"]
    assert len(j_stats) == len(t_stats) == len(_leaves(stats))
    for a, s, s0 in zip(t_stats, j_stats, _leaves(stats)):
        np.testing.assert_allclose(a, s, atol=1e-6, rtol=0)
        assert not np.array_equal(a, s0)


def check_bf16_grad(pair: Pair, params, stats, b: int = B) -> None:
    """bf16 compute over a batch of ``b``: the whole gradient at cosine
    >= 0.98 of JAX's bf16 gradient, and at least as close to JAX's
    float32 gradient as JAX's bf16 gradient is (within 0.005)."""
    def whole(gs):
        return np.concatenate([g.ravel() for g in gs])

    j16, t16 = map(whole, train_grads(pair, "bfloat16", params, stats,
                                      b=b)["grad"])
    j32 = whole(train_grads(pair, "float32", params, stats, b=b)["grad"][0])
    assert _cos(t16, j16) >= 0.98
    assert _cos(t16, j32) >= _cos(j16, j32) - 0.005


def check_bridge(pair: Pair, params, stats) -> None:
    """JAX -> port -> JAX bit for bit; the port's own init -> Flax ->
    port bit for bit."""
    sd = bridge.variables_to_state_dict(params, stats, SIDE)
    p2, s2 = bridge.state_dict_to_variables(sd, SIDE)
    assert (s2 is None) == (not stats)
    for a, b in ((params, p2), (stats, s2 or {})):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(_leaves(a), _leaves(b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    model = pair.port("float32")
    model.reset_parameters(torch.Generator().manual_seed(1))
    sd0 = model.state_dict()
    sd1 = bridge.variables_to_state_dict(
        *bridge.state_dict_to_variables(sd0, SIDE), SIDE)
    assert sd1.keys() == sd0.keys()
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)


def check_session_model(pair: Pair, params, stats, tmp_path) -> None:
    """A JAX-written ``session_model.msgpack`` read and written again by
    the port is the same bytes, and the port's own init through the JAX
    package too; the JAX-written file predicts in the port as in JAX."""
    jcfg = JModelConfig(name=pair.name, image_size=SIDE,
                        compute_dtype="float32")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_model(jpath, jcfg, params, stats or None)
    cfg, sd = tckpt.load_model(jpath)
    assert cfg == tcfg
    tckpt.save_model(tpath, cfg, sd)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    model = pair.port("float32")
    model.load_state_dict(sd)
    x, _ = batch(7)
    jm = pair.jax("float32")
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        _variables(params, stats), jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    model.reset_parameters(torch.Generator().manual_seed(8))
    tckpt.save_model(tpath, tcfg, model.state_dict())
    _, loaded = jckpt.load_model(tpath)
    p, s = jckpt.split_variables(loaded)
    jckpt.save_model(jpath, jcfg, p, s)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()


def keras_layers(params, stats, rng, head_in: int, extra=()):
    """A Keras model's weighted layers for these variables, in the Keras
    layouts and with the Keras layer names (each Flax module's own name,
    at any depth): BatchNorms, conv kernels (``[k, k, I, O]``, with their
    biases) and depthwise kernels (``[k, k, C, 1]``); weightless layers
    between them, the ImageNet head ``predictions`` and the layers in
    ``extra``, all of which a loader skips."""
    layers = [("input_1", {})]

    def walk(p):
        for name, v in p.items():
            if name == "Dense_0":
                continue
            if "scale" in v:
                c = v["scale"].shape[0]
                layers.append((name, {
                    "gamma": rng.standard_normal(c),
                    "beta": rng.standard_normal(c),
                    "moving_mean": rng.standard_normal(c),
                    "moving_variance": rng.uniform(0.5, 1.5, c)}))
                layers.append((f"{name}_activation", {}))
            elif "kernel" in v:
                k = v["kernel"].shape
                if k[2] == 1 and ("depthwise" in name or "dwconv" in name):
                    w = {"depthwise_kernel": rng.standard_normal(
                        (k[0], k[1], k[3], 1))}
                else:
                    w = {"kernel": rng.standard_normal(k)}
                    if "bias" in v:
                        w["bias"] = rng.standard_normal(k[3])
                layers.append((name, w))
            else:
                walk(v)

    walk(params)
    layers += [*extra, ("avg_pool", {}), ("predictions", {
        "kernel": rng.standard_normal((head_in, 1000)),
        "bias": rng.standard_normal(1000)})]
    return [(n, {k: np.asarray(v, np.float32) for k, v in w.items()})
            for n, w in layers]


def check_h5(jload, tload, params, stats, layers, tmp_path,
             monkeypatch) -> None:
    """A legacy-layout ``.h5`` written here loads into both packages as
    the same numbers, bit for bit; the head is left as it was, every
    other tensor replaced; without h5py the reader raises an ImportError
    naming it."""
    path = str(tmp_path / "weights.h5")
    _write_h5(path, layers)
    dst = bridge.variables_to_state_dict(params, stats, SIDE)
    got = tload(path, dst)
    want = jload(path, _variables(params, stats))
    want = bridge.variables_to_state_dict(
        _np(want["params"]), _np(want.get("batch_stats", {})), SIDE)
    assert got.keys() == want.keys() == dst.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], dst[k]) == k.startswith("head."), k
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tload(path, dst)


# -- every registered name -------------------------------------------------

def test_the_port_registers_every_name_the_jax_package_does():
    build_model(ModelConfig(name="vgg16", image_size=SIDE), device="meta")
    # the JAX package builds its flagship models outside the registry
    assert set(tregistry._REGISTRY) == set(jregistry._REGISTRY) | {
        "skin_cancer", "skin_cancer_list"}
    assert not hasattr(tregistry, "NOT_PORTED")


def _port_shapes(name: str) -> dict[str, tuple]:
    model = build_model(ModelConfig(name=name, image_size=SIDE),
                        device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", KERAS_FAMILIES)
def test_full_size_state_dict_matches_jax_eval_shape(name):
    """The registered model at full size: the port's ``state_dict`` (built
    on the meta device) has the keys and shapes of the JAX init's
    variables (``jax.eval_shape``) carried through the bridge."""
    model = jcnn.build_model(JModelConfig(name=name, image_size=SIDE))
    shapes = jax.eval_shape(
        lambda k: model.init({"params": k}, jnp.zeros((1, SIDE, SIDE, 3)),
                             train=False), jax.random.key(0))
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    sd = bridge.variables_to_state_dict(zeros["params"],
                                        zeros.get("batch_stats"), SIDE)
    assert {k: tuple(v.shape) for k, v in sd.items()} == _port_shapes(name)


def _jax_drop_rates(name: str, monkeypatch) -> dict[str, float]:
    """The stochastic-depth Dropouts a JAX train-mode init creates, as
    {block: rate}, recorded during ``jax.eval_shape``."""
    seen = {}
    call = fnn.Dropout.__call__

    def record(self, *a, **kw):
        if tuple(self.broadcast_dims) == (1, 2, 3):
            assert self.name.endswith("_drop")
            seen[self.name[:-len("_drop")]] = self.rate
        return call(self, *a, **kw)

    monkeypatch.setattr(fnn.Dropout, "__call__", record)
    model = jcnn.build_model(JModelConfig(name=name, image_size=SIDE))
    jax.eval_shape(
        lambda k: model.init({"params": k, "dropout": k},
                             jnp.zeros((1, SIDE, SIDE, 3)), train=True),
        jax.random.key(0))
    return seen


@pytest.mark.parametrize("name", [n for n in KERAS_FAMILIES
                                  if n.startswith("efficientnet")])
def test_stochastic_depth_rates_match_jax_block_by_block(name,
                                                         monkeypatch):
    """Each residual block's drop rate as the JAX module sets it: v1 over
    the depth-scaled block count, v2 over the unscaled repeat sum (so
    B1-B3 pass drop_connect_rate near the tail); no drop at rate 0."""
    model = build_model(ModelConfig(name=name, image_size=SIDE),
                        device="meta")
    want = _jax_drop_rates(name, monkeypatch)
    assert model.drop_rates() == want and want
    if name in ("efficientnet_v2_b2", "efficientnet_v2_b3"):
        assert max(want.values()) > 0.2


def test_stochastic_depth_drops_whole_samples():
    """A residual block in training keeps or drops each sample's whole
    branch, the kept ones scaled by 1 / (1 - rate); in eval it drops
    nothing."""
    block = teff.MBConv("block2b", 16, 16, 3, 1, 6, 0.5, "float32")
    g = torch.Generator().manual_seed(3)
    for m in block.modules():
        if isinstance(m, (Conv, BatchNorm)):
            m.reset_parameters(g)
    x = torch.randn(32, 16, 6, 6, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        evaluated = block(x, False, None)
        block.drop_rate = 0.0
        assert torch.equal(block(x, False, None), evaluated)
        branch = block(x, True, None) - x
        block.drop_rate = 0.5
        got = block(x, True, torch.Generator().manual_seed(5)) - x
    kept = [torch.allclose(g, 2 * b, atol=1e-6) for g, b in zip(got, branch)]
    dropped = [bool((g.abs() <= 1e-6).all()) for g in got]
    assert all(k != d for k, d in zip(kept, dropped))
    assert 4 < sum(dropped) < 28

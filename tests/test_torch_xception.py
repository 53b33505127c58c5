"""The port's Xception family, its Keras weight loader, the weight bridge
and the checkpoints of an Xception run, against the JAX package's Flax
Xception on the CPU, with the same weights carried across.

One jitted JAX init of ``xception_small`` (about 7 s on the CPU) is shared
through a module-scoped fixture; the full depth is checked against the
published Keras parameter counts without a JAX init."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from skin_image_analysis_tpu.config import ModelConfig as JModelConfig
from skin_image_analysis_tpu.config import OptimConfig as JOptimConfig
from skin_image_analysis_tpu.models import registry as jregistry
from skin_image_analysis_tpu.models import xception as jxception
from skin_image_analysis_tpu.train import checkpoint as jckpt
from skin_image_analysis_tpu.train import state as jstate
from skin_image_analysis_tpu.train.step import make_train_step
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig
from skin_image_analysis_tpu_torch.models import keras_io
from skin_image_analysis_tpu_torch.models import registry as tregistry
from skin_image_analysis_tpu_torch.models import xception as txception
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from skin_image_analysis_tpu_torch.train import state as tstate
from skin_image_analysis_tpu_torch.train.step import train_step
from tests.test_torch_resnet import _cos, _leaves, _np, perturb

SIDE, B = 32, 8
NAME = "xception_small"


@pytest.fixture(scope="module")
def jvars():
    """(params, batch_stats) of a jitted xception_small init with random
    BatchNorm scales, biases and statistics, as numpy trees no test
    changes."""
    model = jxception.Xception(middle_blocks=2, compute_dtype="float32")
    v = jax.jit(lambda k: model.init({"params": k},
                                     jnp.zeros((1, SIDE, SIDE, 3)),
                                     train=False))(jax.random.key(0))
    return perturb(_np(v["params"]), _np(v["batch_stats"]), 0)


def conditioned(params, scale=0.2):
    """``params`` with the last BatchNorm scale of each residual branch
    times ``scale``: with every branch at full scale a random Xception's
    train-mode gradient is ill-conditioned, as a ResNet's is (float32
    reassociation moves 20 of its leaves past 1e-5 + 1e-4 relative between
    the packages; at 0.2, none)."""
    last = {f"block{bi}_sepconv2_bn" for bi in (2, 3, 4, 7)} | {
        f"block{bi}_sepconv3_bn" for bi in (5, 6)}
    return {k: {**v, "scale": v["scale"] * np.float32(scale)}
            if k in last else v for k, v in params.items()}


def jmodel(compute_dtype="float32", freeze_backbone=False):
    return jxception.Xception(middle_blocks=2, head_dropout=0.0,
                              compute_dtype=compute_dtype,
                              freeze_backbone=freeze_backbone)


def port_model(params, stats, compute_dtype="float32"):
    model = build_model(ModelConfig(name=NAME, image_size=SIDE,
                                    compute_dtype=compute_dtype),
                        device="cpu")
    model.load_state_dict(bridge.variables_to_state_dict(params, stats, SIDE))
    model.head_dropout = 0.0
    return model


def _batch(seed, side=SIDE):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, side, side, 3)).astype(np.float32)
    labels = np.arange(B, dtype=np.int32) % 2
    valid = np.arange(B) != 2
    return x, labels, valid


@pytest.mark.parametrize("side", [32, 37])
def test_forward_matches_jax_and_sizes_agree(side, jvars):
    """float32 eval log-probs within 2e-5 of JAX's, at 32² (its pools take
    4 -> 2 and 2 -> 1, the even sides' asymmetric pad) and at 37² (16 -> 8,
    8 -> 4, 4 -> 2, 2 -> 1)."""
    params, stats = jvars
    model = port_model(params, stats)
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in _leaves(params))
    assert sum(b.numel() for b in model.buffers()) == \
        sum(x.size for x in _leaves(stats))
    x, _, _ = _batch(side, side)
    want = jax.jit(lambda v, x: jmodel().apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_full_depth_has_keras_xception_sizes():
    """``xception``: the published Keras ``Xception(include_top=False)``
    counts, 20,806,952 trainable and 54,528 BatchNorm statistics, 40
    BatchNorms and 34 depthwise convs; plus the 2-class head."""
    model = build_model(ModelConfig(name="xception", image_size=SIDE),
                        device="cpu")
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params - model.head.weight.numel() - 2 == 20_806_952
    assert sum(b.numel() for b in model.buffers()) == 54_528
    bns = [m for m in model.modules()
           if isinstance(m, txception.BatchNorm)]
    assert len(bns) == 40 and all(bn.eps == 1e-3 for bn in bns)
    assert sum(1 for m in model.modules()
               if isinstance(m, txception.Conv) and m.groups > 1) == 34
    assert {"xception", "xception_small"} <= set(tregistry._REGISTRY)


@pytest.mark.parametrize("side", [4, 5, 14, 28])
def test_max_pool_same_pads_as_flax_and_padding_1_would_not(side):
    """TF "SAME" with -inf: an even side pads 0 before and 1 after. The
    symmetric ``padding=1`` gives the same shape, and on an even side other
    windows."""
    rng = np.random.default_rng(side)
    x = rng.standard_normal((2, 3, side, side)).astype(np.float32)
    want = np.asarray(fnn.max_pool(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                   (3, 3), strides=(2, 2), padding="SAME"))
    got = txception.max_pool_same(torch.from_numpy(x))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    sym = torch.nn.functional.max_pool2d(torch.from_numpy(x), 3, 2,
                                         padding=1)
    assert sym.shape == got.shape
    assert torch.equal(sym, got) == (side % 2 == 1)


def test_residual_convs_pad_nothing():
    """The 1x1 stride-2 residual conv under Flax's default "SAME" samples
    the even positions, at odd and even sides, as the port's unpadded
    conv does."""
    for side in (7, 8):
        x = np.random.default_rng(side).standard_normal(
            (1, side, side, 4)).astype(np.float32)
        conv = fnn.Conv(5, (1, 1), (2, 2), use_bias=False)
        v = conv.init(jax.random.key(1), jnp.asarray(x))
        want = np.asarray(conv.apply(v, jnp.asarray(x)))
        got = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(np.asarray(v["params"]["kernel"]).transpose(
                3, 2, 0, 1).copy()), stride=2)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-6, rtol=0)


def _jax_state(params, stats, optim, freeze=False):
    model = jmodel(freeze_backbone=freeze)
    tx = jstate.make_optimizer(optim)
    params = jax.tree.map(jnp.asarray, params)
    if freeze:
        tx = optax.multi_transform(
            {"trainable": tx, "frozen": optax.set_to_zero()},
            jstate._freeze_labels(params))
    return jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=tx.init(params), rng=jax.random.key(0),
        apply_fn=model.apply, tx=tx,
        batch_stats=jax.tree.map(jnp.asarray, stats))


def _port_state(params, stats, optim, freeze=False):
    state = tstate.create_train_state(
        ModelConfig(name=NAME, image_size=SIDE, compute_dtype="float32",
                    freeze_backbone=freeze), optim, 0, device="cpu")
    state.model.load_state_dict(
        bridge.variables_to_state_dict(params, stats, SIDE))
    state.model.head_dropout = 0.0
    return state


def _step(jst, tst, seed, class_weights=None):
    x, labels, valid = _batch(seed)
    jst, jm = make_train_step(class_weights=class_weights)(jst, {
        "pixels": jnp.asarray(x), "label": jnp.asarray(labels),
        "valid": jnp.asarray(valid)})
    tm = train_step(tst, torch.from_numpy(x), torch.from_numpy(labels),
                    torch.from_numpy(valid), class_weights)
    return jst, jm, tm


def test_one_train_step_with_batch_stats_matches_jax(jvars):
    """float32, dropout off, one row invalid (it still counts in the batch
    statistics), sgd at lr 0.1: the loss within 5e-6 (the ResNets' rule:
    train-mode BatchNorm divides by batch deviations whose float32 sums
    the two packages round differently), every parameter after the update
    within 1e-5, every running_mean / running_var within 1e-6 of JAX's
    batch_stats and moved."""
    params, stats = jvars
    optim = dict(optimizer="sgd", learning_rate=0.1)
    tst = _port_state(params, stats, OptimConfig(**optim))
    jst, jm, tm = _step(_jax_state(params, stats, JOptimConfig(**optim)),
                        tst, 1, class_weights=(0.7, 1.6))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 5e-6
    assert int(tm["count"]) == int(jm["count"]) == B - 1
    got_p, got_s = bridge.state_dict_to_variables(tst.model.state_dict(),
                                                  SIDE)
    assert jax.tree.structure(got_p) == jax.tree.structure(_np(jst.params))
    for a, b in zip(_leaves(got_p), _leaves(jst.params)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    moved = 0
    for a, b, s0 in zip(_leaves(got_s), _leaves(jst.batch_stats),
                        _leaves(stats)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        moved += not np.array_equal(a, s0)
    assert moved == len(_leaves(stats)) == 44


def _grads(compute_dtype, params, stats, x, labels):
    """Both packages' train-mode gradients of the mean NLL, as leaf lists
    in Flax order."""
    model = jmodel(compute_dtype)

    def loss(p):
        lp, _ = model.apply({"params": p, "batch_stats": stats},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return -jnp.mean(jnp.take_along_axis(
            lp, jnp.asarray(labels)[:, None], axis=-1))

    g_j = jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, params))
    tmodel = port_model(params, stats, compute_dtype)
    lp = tmodel(torch.from_numpy(x), train=True)
    (-lp.gather(1, torch.from_numpy(labels).long()[:, None]).mean()).backward()
    g_t, _ = bridge.state_dict_to_variables(
        {**{k: p.grad for k, p in tmodel.named_parameters()},
         **dict(tmodel.named_buffers())}, SIDE)
    return _leaves(g_j), _leaves(g_t)


def test_bf16_gradients_match_jax(jvars):
    """bf16 compute against JAX's bf16 gradient, held by the ResNets' rule:
    the whole gradient to cosine 0.98 of JAX's, and the port's as close to
    the float32 gradient as JAX's is (the whole within 0.005 of JAX's
    cosine, each leaf within 0.02), on :func:`conditioned` parameters. The
    float32 gradients agree leaf by leaf to 1e-5 absolute + 1e-4
    relative. JAX's bf16 gradient is taken jitted: op by op it costs about
    35 s of compiles on the CPU. XLA's fusions keep float32 between fused
    ops; measured, the port's whole gradient is at cosine 0.985 of it,
    and at 0.988 of the float32 gradient, as JAX's is (0.988). Without the
    conditioning the two bf16 gradients lie at 0.933."""
    params, stats = jvars
    params = conditioned(params)
    x, labels, _ = _batch(2)
    j16, t16 = _grads("bfloat16", params, stats, x, labels)
    j32, t32 = _grads("float32", params, stats, x, labels)
    assert len(j16) == len(t16) == len(_leaves(params))
    for a, b in zip(t32, j32):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)

    def whole(gs):
        return np.concatenate([g.ravel() for g in gs])

    assert _cos(whole(t16), whole(j16)) > 0.98
    assert _cos(whole(t16), whole(j32)) > _cos(whole(j16), whole(j32)) - 0.005
    for a, b, ref in zip(t16, j16, j32):
        assert _cos(a, ref) > _cos(b, ref) - 0.02


def test_freeze_backbone_trains_the_head_only_as_jax_does(jvars):
    """adamw: the backbone bit-unchanged, the head as JAX updates it (to
    1e-6), every BatchNorm statistic moved."""
    params, stats = jvars
    optim = dict(optimizer="adamw", learning_rate=1e-2)
    tst = _port_state(params, stats, OptimConfig(**optim), freeze=True)
    before = {k: v.clone() for k, v in tst.model.state_dict().items()}
    jst, _, _ = _step(_jax_state(params, stats, JOptimConfig(**optim),
                                 freeze=True), tst, 5)
    after = tst.model.state_dict()
    for k, v in before.items():
        if k.startswith("head.") or "running" in k:
            assert not torch.equal(v, after[k]), k
        else:
            assert torch.equal(v, after[k]), k
    for mine, theirs in (("head.weight", jst.params["Dense_0"]["kernel"].T),
                         ("head.bias", jst.params["Dense_0"]["bias"])):
        np.testing.assert_allclose(after[mine].numpy(), np.asarray(theirs),
                                   atol=1e-6, rtol=0)


def test_bridge_round_trips_params_and_batch_stats(jvars):
    params, stats = jvars
    sd = bridge.variables_to_state_dict(params, stats, SIDE)
    p2, s2 = bridge.state_dict_to_variables(sd, SIDE)
    for a, b in ((params, p2), (stats, s2)):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(_leaves(a), _leaves(b)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    # the port's own full-depth init through Flax and back
    model = build_model(ModelConfig(name="xception", image_size=SIDE,
                                    in_channels=2), device="cpu",
                        generator=torch.Generator().manual_seed(1))
    sd0 = model.state_dict()
    sd1 = bridge.variables_to_state_dict(
        *bridge.state_dict_to_variables(sd0, SIDE), SIDE)
    assert sd1.keys() == sd0.keys()
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert sd0["block1_conv1.weight"].shape == (32, 2, 3, 3)


def _keras_layers(params, stats, rng):
    """Keras Xception's layer list for these variables, in build order,
    with each layer's weights in Keras's layouts: auto-named residual
    convs and BatchNorms (with suffixes whose numeric order is not their
    string order), weightless activation, pool and add layers, and an
    ImageNet head."""
    def bn(name):
        c = params[name]["scale"].shape[0]
        return {"gamma": rng.standard_normal(c),
                "beta": rng.standard_normal(c),
                "moving_mean": rng.standard_normal(c),
                "moving_variance": rng.uniform(0.5, 1.5, c)}

    def conv(name):
        return {"kernel": rng.standard_normal(params[name]["kernel"].shape)}

    def sep(name):
        dw = params[name]["depthwise"]["kernel"].shape  # [3, 3, 1, C]
        return {"depthwise_kernel": rng.standard_normal(
                    (dw[0], dw[1], dw[3], 1)),
                "pointwise_kernel": rng.standard_normal(
                    params[name]["pointwise"]["kernel"].shape)}

    layers = [("input_1", {})]
    for name in ("block1_conv1", "block1_conv2"):
        layers += [(name, conv(name)), (f"{name}_bn", bn(f"{name}_bn")),
                   (f"{name}_act", {})]
    n_blocks = max(int(k.split("_")[0][5:]) for k in params
                   if k.startswith("block"))
    suffix = iter(["_8", "_9", "_10", "_11"])
    for bi in range(2, n_blocks + 1):
        if bi in (2, 3, 4, n_blocks - 1):
            s = next(suffix)
            layers += [(f"conv2d{s}", conv(f"block{bi}_res_conv")),
                       (f"batch_normalization{s}", bn(f"block{bi}_res_bn"))]
        for si in (1, 2, 3):
            name = f"block{bi}_sepconv{si}"
            if name in params:
                layers += [(f"{name}_act", {}), (name, sep(name)),
                           (f"{name}_bn", bn(f"{name}_bn"))]
        layers.append((f"add_{bi}", {}))
    layers += [("avg_pool", {}),
               ("predictions", {"kernel": rng.standard_normal((2048, 1000)),
                                "bias": rng.standard_normal(1000)})]
    return [(n, {k: v.astype(np.float32) for k, v in w.items()})
            for n, w in layers]


def _write_h5(path, layers):
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([n.encode() for n, _ in layers])
        for name, weights in layers:
            g = f.create_group(name)
            g.attrs["weight_names"] = np.array(
                [f"{name}/{k}:0".encode() for k in weights], dtype="S64")
            for k, v in weights.items():
                g.create_dataset(f"{name}/{k}:0", data=v)


def test_keras_h5_loads_into_both_packages_alike(jvars, tmp_path,
                                                 monkeypatch):
    """A legacy-layout ``.h5`` written here: the port's loader gives,
    bit for bit, the bridge of what the JAX package's loader gives; the
    head is left as it was; a shape mismatch raises ValueError; without
    h5py the reader raises an ImportError naming it."""
    params, stats = jvars
    layers = _keras_layers(params, stats, np.random.default_rng(3))
    path = str(tmp_path / "xception_small.h5")
    _write_h5(path, layers)
    names, table = keras_io.read_legacy_h5(path)
    assert names == [n for n, _ in layers]
    assert table["block2_sepconv1"]["depthwise_kernel"].shape == (3, 3, 64, 1)
    dst = bridge.variables_to_state_dict(params, stats, SIDE)
    got = txception.load_keras_xception_weights(path, dst)
    want = jxception.load_keras_xception_weights(
        path, {"params": params, "batch_stats": stats})
    want = bridge.variables_to_state_dict(_np(want["params"]),
                                          _np(want["batch_stats"]), SIDE)
    assert got.keys() == want.keys() == dst.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["head.weight"], dst["head.weight"])
    assert not torch.equal(got["block2_res_conv.weight"],
                           dst["block2_res_conv.weight"])
    two = build_model(ModelConfig(name=NAME, image_size=SIDE, in_channels=2),
                      device="cpu").state_dict()
    with pytest.raises(ValueError, match="block1_conv1.weight"):
        txception.load_keras_xception_weights(path, two)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        keras_io.read_legacy_h5(path)


def test_session_model_is_byte_equal_both_ways(jvars, tmp_path):
    params, stats = jvars
    jcfg = JModelConfig(name=NAME, image_size=SIDE, compute_dtype="float32")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_model(jpath, jcfg, params, stats)
    cfg, sd = tckpt.load_model(jpath)
    assert cfg == tcfg and "block2_sepconv1_bn.running_var" in sd
    tckpt.save_model(tpath, cfg, sd)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    # a JAX-written file predicts in the port as in JAX
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    x, _, _ = _batch(7)
    want = np.asarray(jax.jit(lambda v, x: jmodel().apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # the port's own weights, through the JAX package and back
    model = build_model(tcfg, device="cpu",
                        generator=torch.Generator().manual_seed(8))
    tckpt.save_model(tpath, tcfg, model.state_dict())
    _, loaded = jckpt.load_model(tpath)
    jckpt.save_model(jpath, jcfg, loaded["params"], loaded["batch_stats"])
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    assert NAME in jregistry._REGISTRY

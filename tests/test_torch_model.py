"""The port's model and weight bridge against the JAX package's Flax
model, on the CPU, with the same weights carried across."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu.config import ModelConfig as JModelConfig
from skin_image_analysis_tpu.models import cnn as jcnn
from skin_image_analysis_tpu.ops import pooling as jpool
from skin_image_analysis_tpu.ops.losses import nll_loss as jnll
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models import cnn as tcnn
from skin_image_analysis_tpu_torch.ops import pooling as tpool
from skin_image_analysis_tpu_torch.ops.losses import nll_loss as tnll
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(conv_features=(32, 64), linear_features=(16,), dropout=(0.0,),
             image_size=32)


def _flax_params(cfg: JModelConfig, seed=0):
    model = jcnn.build_model(cfg)
    x = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32)
    params = model.init({"params": jax.random.key(seed)}, x)["params"]
    return model, jax.tree.map(np.asarray, params)


def _assert_trees_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,kw", [
    ("skin_cancer_list", SMALL),
    ("skin_cancer", dict(image_size=32)),
])
def test_bridge_round_trips_bit_exactly(name, kw):
    cfg = JModelConfig(name=name, compute_dtype="float32", **kw)
    _, params = _flax_params(cfg)
    wrap = name == "skin_cancer"
    sd = bridge.flax_to_state_dict(params, cfg.image_size)
    _assert_trees_equal(bridge.state_dict_to_flax(sd, cfg.image_size, wrap),
                        params)
    # and torch -> Flax -> torch, from the port's own init
    tmodel = tcnn.build_model(ModelConfig(name=name, **kw), device="cpu",
                              generator=torch.Generator().manual_seed(1))
    sd0 = tmodel.state_dict()
    sd1 = bridge.flax_to_state_dict(
        bridge.state_dict_to_flax(sd0, cfg.image_size, wrap), cfg.image_size)
    assert sd1.keys() == sd0.keys()
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    tmodel.load_state_dict(sd)  # the Flax tree fits the port's model


def _both(compute_dtype, seed=0):
    jcfg = JModelConfig(compute_dtype=compute_dtype, **SMALL)
    jmodel, params = _flax_params(jcfg, seed)
    tmodel = tcnn.build_model(ModelConfig(compute_dtype=compute_dtype,
                                          **SMALL), device="cpu")
    tmodel.load_state_dict(bridge.flax_to_state_dict(params, 32))
    assert [b.pool_mode for b in tmodel.conv_blocks] == ["phase", "selector"]
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0], np.int32)

    def jloss(p):
        lp = jmodel.apply({"params": p}, jnp.asarray(x), train=False)
        return jnll(lp, jnp.asarray(labels)), lp

    (_, lp_j), g_j = jax.value_and_grad(jloss, has_aux=True)(params)
    lp_t = tmodel(torch.from_numpy(x))
    tnll(lp_t, torch.from_numpy(labels)).backward()
    g_t = bridge.state_dict_to_flax(
        {k: p.grad for k, p in tmodel.named_parameters()}, 32)
    return (np.asarray(lp_j), lp_t.detach().numpy(),
            jax.tree.leaves(jax.tree.map(np.asarray, g_j)),
            jax.tree.leaves(g_t))


def test_forward_and_grads_match_jax_f32():
    lp_j, lp_t, g_j, g_t = _both("float32")
    assert lp_t.dtype == np.float32
    np.testing.assert_allclose(lp_t, lp_j, atol=1e-4)
    assert len(g_j) == len(g_t) == 8
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def test_forward_and_grads_match_jax_bf16():
    """The whole gradient to cosine 0.999. A conv bias's gradient is a
    bf16 reduction over B*H*W positions that XLA and PyTorch order and
    accumulate differently (each is ~0.99 from the f32 gradient), so a
    single bias leaf holds to 0.995."""
    lp_j, lp_t, g_j, g_t = _both("bfloat16", seed=2)
    np.testing.assert_allclose(lp_t, lp_j, atol=5e-2)
    assert _cos(np.concatenate([g.ravel() for g in g_t]),
                np.concatenate([g.ravel() for g in g_j])) > 0.999
    for a, b in zip(g_t, g_j):
        assert _cos(a, b) > (0.995 if a.ndim == 1 else 0.999)


def test_params_stay_float32_and_output_is_float32_in_bf16():
    model = tcnn.build_model(ModelConfig(**SMALL), device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = model(torch.rand(2, 32, 32, 3))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.exp().sum(-1).detach().numpy(), 1.0,
                               rtol=1e-5)


def test_dropout_draws_from_the_generator():
    model = tcnn.build_model(ModelConfig(conv_features=(32,),
                                         linear_features=(64,),
                                         dropout=(0.5,), image_size=8,
                                         compute_dtype="float32"),
                             device="cpu")
    x = torch.rand(3, 8, 8, 3)
    a = model(x, train=True, generator=torch.Generator().manual_seed(5))
    b = model(x, train=True, generator=torch.Generator().manual_seed(5))
    c = model(x, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(model(x), model(x))


def test_resolve_stem_and_unported_stem():
    """"auto" resolves to "phase"; the s2d stem and remat, which the port
    once refused, build and run the stem."""
    assert tcnn.resolve_stem(ModelConfig()) == "phase"
    assert tcnn.resolve_stem(ModelConfig(stem="s2d")) == "s2d"
    model = tcnn.build_model(ModelConfig(stem="s2d", remat=True, **SMALL),
                             device="cpu")
    assert model.s2d_stem and model.remat
    assert model(torch.rand(2, 32, 32, 3)).shape == (2, 2)


S2D = dict(SMALL, stem="s2d", compute_dtype="float32")


def test_s2d_stem_matches_jax_on_bridged_weights():
    """The JAX s2d-stem model's param tree is the phase stem's and bridges
    unchanged; on it the port's s2d model matches JAX's from raw NHWC and
    from space-to-depth input: log-probs to 1e-4, grads to 1e-4."""
    jmodel, params = _flax_params(JModelConfig(**S2D))
    _, phase_params = _flax_params(JModelConfig(**dict(S2D, stem="phase")))
    assert jax.tree.structure(params) == jax.tree.structure(phase_params)
    tmodel = tcnn.build_model(ModelConfig(**S2D), device="cpu")
    tmodel.load_state_dict(bridge.flax_to_state_dict(params, 32))
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    z = np.array(jpool.space_to_depth_nhwc(jnp.asarray(x)))
    labels = np.array([1, 0, 1, 1], np.int32)

    def jloss(p):
        lp = jmodel.apply({"params": p}, jnp.asarray(x), train=False)
        return jnll(lp, jnp.asarray(labels)), lp

    (_, lp_j), g_j = jax.value_and_grad(jloss, has_aux=True)(params)
    for inp in (x, z):
        tmodel.zero_grad()
        lp_t = tmodel(torch.from_numpy(inp))
        tnll(lp_t, torch.from_numpy(labels)).backward()
        np.testing.assert_allclose(lp_t.detach().numpy(), np.asarray(lp_j),
                                   atol=1e-4)
        g_t = bridge.state_dict_to_flax(
            {k: p.grad for k, p in tmodel.named_parameters()}, 32)
        for a, b in zip(jax.tree.leaves(g_t),
                        jax.tree.leaves(jax.tree.map(np.asarray, g_j))):
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)


def test_s2d_raw_input_with_4_channels_is_transformed():
    """in_channels=4: a raw 4-channel input is transformed by the model,
    a 16-channel one is taken as already in the s2d layout; both match
    the phase stem on the same weights."""
    kw = dict(conv_features=(8,), linear_features=(8,), dropout=(0.0,),
              image_size=16, in_channels=4, compute_dtype="float32")
    ref = tcnn.build_model(ModelConfig(stem="phase", **kw), device="cpu")
    model = tcnn.build_model(ModelConfig(stem="s2d", **kw), device="cpu")
    model.load_state_dict(ref.state_dict())
    x = torch.rand(2, 16, 16, 4)
    z = tpool.space_to_depth(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    with torch.no_grad():
        want = ref(x)
        torch.testing.assert_close(model(x), want, rtol=0, atol=1e-5)
        torch.testing.assert_close(model(z), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(stem="s2d"), dict(stem="phase"), dict(stem="auto"),
    dict(stem="s2d", fused_pool=False), dict(stem="s2d", first_kernel=4),
    dict(stem="s2d", name="skin_cancer"), dict(stem="s2d", name="resnet18"),
])
def test_stem_wants_s2d_matches_jax(kw):
    kw = dict(dict(conv_features=(8,), linear_features=(8,),
                   dropout=(0.2,)), **kw)
    assert tcnn.stem_wants_s2d(ModelConfig(**kw)) == \
        jcnn.stem_wants_s2d(JModelConfig(**kw))


@pytest.mark.parametrize("stem", ["phase", "s2d"])
def test_remat_gives_the_same_grads(stem):
    """Recomputing each conv block in the backward changes neither the
    parameters' names nor the output or the gradients (bit for bit on
    the CPU)."""
    grads = []
    for remat in (False, True):
        model = tcnn.build_model(
            ModelConfig(stem=stem, remat=remat, **SMALL), device="cpu",
            generator=torch.Generator().manual_seed(3))
        x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(4))
        out = model(x, train=True,
                    generator=torch.Generator().manual_seed(5))
        out.sum().backward()
        grads.append({"out": out.detach(),
                      **{k: p.grad for k, p in model.named_parameters()}})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k

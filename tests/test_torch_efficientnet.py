"""The port's EfficientNet (v1) against the JAX package's on the CPU,
with the same weights carried across: a reduced-depth
``EfficientNet(depth_coefficient=0.5)`` of both packages (10 blocks: every
stage, its 3x3 and 5x5 stride-2 depthwise convs, three adding blocks) from
one jitted JAX init shared through a module-scoped fixture; the nesting
of the block's parameters in the bridge and the ``.h5`` loader; and the
``correct_pad`` geometry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from skin_image_analysis_tpu.models import efficientnet as jeff
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch.models import efficientnet as teff
from skin_image_analysis_tpu_torch.models.resnet import Conv
from tests.test_torch_families import (
    SIDE,
    Pair,
    check_bf16_grad,
    check_bridge,
    check_forward,
    check_h5,
    check_session_model,
    check_train_step,
    jax_variables,
    keras_layers,
    one_torch_thread,  # noqa: F401  (the module's fixture)
    scaled_bns,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PAIR = Pair(
    "efficientnet_b0",
    lambda dt: jeff.EfficientNet(depth_coefficient=0.5,
                                 drop_connect_rate=0.0, head_dropout=0.0,
                                 compute_dtype=dt),
    lambda dt: teff.EfficientNet(depth_coefficient=0.5,
                                 drop_connect_rate=0.0, head_dropout=0.0,
                                 compute_dtype=dt))
ADDING = ("block4b", "block5b", "block6b")
# the train-mode gradients' batch: over 8 rows a random EfficientNet's
# gradient is ill-conditioned even with :func:`conditioned` (measured: one
# float32 leaf element 1.6e-5 apart; JAX's own bf16 gradient at cosine
# 0.980 of its float32 gradient, the port's at 0.978 of JAX's); over 16,
# every float32 leaf within 1e-5 + 1e-4 relative, and 0.994 and 0.993
GRAD_BATCH = 16


@pytest.fixture(scope="module")
def jvars():
    return jax_variables(PAIR)


def conditioned(params):
    """The last BatchNorm of each adding block's branch (``_project_bn``)
    at 0.2 of its random scale, as the ResNets' parity tests condition
    theirs."""
    return scaled_bns(params, {f"{b}_project_bn" for b in ADDING})


@pytest.mark.parametrize("side", [32, 37])
def test_forward_matches_jax(side, jvars):
    """32²: the stem and the four stride-2 depthwise convs pad 0 before and
    1 after (3x3) or 1 and 2 (5x5); 37²: 1 and 1 on 37 and 19, 2 and 2 on
    5 (5x5) and 3 (5x5), 0 and 1 on 10."""
    check_forward(PAIR, *jvars, side)


def test_one_train_step_with_batch_stats_matches_jax(jvars):
    """Over a batch of 16 (:data:`GRAD_BATCH`)."""
    params, stats = jvars
    check_train_step(PAIR, conditioned(params), stats, GRAD_BATCH)


def test_bf16_gradient_matches_jax(jvars):
    """Over a batch of 16 (:data:`GRAD_BATCH`)."""
    params, stats = jvars
    check_bf16_grad(PAIR, conditioned(params), stats, GRAD_BATCH)


def test_bridge_round_trips_the_block_nesting(jvars):
    """``params/block2a/block2a_dwconv/kernel`` is the port's
    ``block2a.block2a_dwconv.weight``; the stem and top sit at the root."""
    params, stats = jvars
    check_bridge(PAIR, params, stats)
    sd = bridge.variables_to_state_dict(params, stats, SIDE)
    assert sd["block2a.block2a_dwconv.weight"].shape == (96, 1, 3, 3)
    assert "block2a.block2a_bn.running_var" in sd
    assert {k.split(".")[0] for k in sd if "." in k.partition(".")[2]} == {
        k for k in params if k.startswith("block")}
    assert {"stem_conv.weight", "top_bn.running_mean"} <= set(sd)


def test_session_model_is_byte_equal_both_ways(jvars, tmp_path):
    check_session_model(PAIR, *jvars, tmp_path)


def test_keras_h5_loads_into_both_packages_alike(jvars, tmp_path,
                                                 monkeypatch):
    """Keras's EfficientNet file also holds a ``normalization`` layer with
    weights and weightless ``rescaling`` and ``top_dropout`` layers, all
    skipped."""
    params, stats = jvars
    rng = np.random.default_rng(3)
    extra = [("rescaling", {}),
             ("normalization", {"mean": rng.standard_normal(3),
                                "variance": rng.uniform(0.5, 1, 3),
                                "count": np.array(3.0)}),
             ("top_dropout", {})]
    layers = keras_layers(params, stats, rng, 1280, extra=extra)
    check_h5(jeff.load_keras_efficientnet_weights,
             teff.load_keras_efficientnet_weights, params, stats, layers,
             tmp_path, monkeypatch)


def test_full_depth_has_keras_sizes():
    """``efficientnet_b0``: Keras's ``EfficientNetB0(include_top=False)``
    backbone, 4,007,548 trainable parameters and 42,016 BatchNorm
    statistics; 49 BatchNorms at epsilon 1e-3, 16 blocks with squeeze-
    excite; the same block counts and widths as the JAX tables for every
    variant; head dropout 0.5 (Keras's ``top_dropout`` is not used)."""
    model = teff.EfficientNet(device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n - model.head.weight.numel() - 2 == 4_007_548
    assert sum(b.numel() for b in model.buffers()) == 42_016
    bns = [m for m in model.modules() if isinstance(m, teff.BatchNorm)]
    assert len(bns) == 49 and {bn.eps for bn in bns} == {1e-3}
    assert sum(getattr(model, b).se for b in model.blocks) == 16
    assert model.head_dropout == 0.5
    for v, (w, d) in teff.VARIANTS.items():
        assert (w, d) == jeff._VARIANTS[v][:2]
        assert teff.block_counts(v) == jeff.block_counts(v)
        for f in (16, 32, 40, 80, 112, 192, 320, 1280):
            assert teff.round_filters(f, w) == jeff.round_filters(f, w)


@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("side", [8, 9, 16, 17])
def test_stride2_depthwise_pads_as_correct_pad(side, kernel):
    """A stride-2 depthwise conv over Keras's ``correct_pad`` + VALID (the
    JAX module's) against the port's ``"same"`` conv, 3x3 and 5x5, at even
    and odd sides; on an even side the symmetric ``padding=k // 2`` gives
    the same shape and other values."""
    rng = np.random.default_rng(side * kernel)
    x = rng.standard_normal((2, side, side, 4)).astype(np.float32)
    conv = fnn.Conv(4, (kernel, kernel), (2, 2),
                    padding=jeff._correct_pad(jnp.asarray(x), kernel),
                    feature_group_count=4, use_bias=False)
    v = conv.init(jax.random.key(side), jnp.asarray(x))
    want = np.asarray(conv.apply(v, jnp.asarray(x)))
    mine = Conv(4, 4, kernel, 2, "same", "float32", groups=4)
    mine.weight.data = torch.from_numpy(np.ascontiguousarray(
        np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = mine(xt)
        sym = torch.nn.functional.conv2d(xt, mine.weight, stride=2,
                                         padding=kernel // 2, groups=4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)
    assert sym.shape == got.shape
    assert torch.allclose(sym, got, atol=1e-5) == (side % 2 == 1)

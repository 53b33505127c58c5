"""The port's EfficientNetV2 against the JAX package's on the CPU, with
the same weights carried across: a reduced-depth ``EfficientNetV2(table=
"s", depth_coefficient=0.3)`` of both packages (15 blocks: an adding fused
block with expand ratio 1 and one with 4, adding MBConv blocks, every
stride-2 stage) from one jitted JAX init shared through a module-scoped
fixture; and the SAME padding that the port's families share."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from skin_image_analysis_tpu.models import efficientnet as jeff
from skin_image_analysis_tpu.models import efficientnet_v2 as jeff2
from skin_image_analysis_tpu_torch.models import efficientnet_v2 as teff2
from skin_image_analysis_tpu_torch.models.resnet import Conv, same_pad
from skin_image_analysis_tpu_torch.models.xception import max_pool_same
from tests.test_torch_families import (
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
    "efficientnet_v2_s",
    lambda dt: jeff2.EfficientNetV2(table="s", depth_coefficient=0.3,
                                    drop_connect_rate=0.0, head_dropout=0.0,
                                    compute_dtype=dt),
    lambda dt: teff2.EfficientNetV2(table="s", depth_coefficient=0.3,
                                    drop_connect_rate=0.0, head_dropout=0.0,
                                    compute_dtype=dt))
# the train-mode gradients' batch, as test_torch_efficientnet's
GRAD_BATCH = 16


@pytest.fixture(scope="module")
def jvars():
    return jax_variables(PAIR)


def conditioned(params):
    """The last BatchNorm of each adding block's branch (``_project_bn``)
    at 0.2 of its random scale, as the ResNets' parity tests condition
    theirs."""
    model = PAIR.port("float32")
    return scaled_bns(params, {f"{b.name}_project_bn" for b in model.blocks
                               if b.residual})


def test_reduced_module_has_every_kind_of_block():
    blocks = PAIR.port("float32").blocks
    kinds = {(b.fused, b.expands, b.se) for b in blocks if b.residual}
    assert kinds == {(True, False, False), (True, True, False),
                     (False, True, True)}
    assert len(blocks) == 15


@pytest.mark.parametrize("side", [32, 37])
def test_forward_matches_jax(side, jvars):
    """32²: the stem and four stride-2 convs pad 0 before and 1 after; 37²:
    1 and 1 on 37, 19, 5 and 3, 0 and 1 on 10."""
    check_forward(PAIR, *jvars, side)


def test_one_train_step_with_batch_stats_matches_jax(jvars):
    params, stats = jvars
    check_train_step(PAIR, conditioned(params), stats, GRAD_BATCH)


def test_bf16_gradient_matches_jax(jvars):
    params, stats = jvars
    check_bf16_grad(PAIR, conditioned(params), stats, GRAD_BATCH)


def test_bridge_round_trips(jvars):
    check_bridge(PAIR, *jvars)


def test_session_model_is_byte_equal_both_ways(jvars, tmp_path):
    check_session_model(PAIR, *jvars, tmp_path)


def test_keras_h5_loads_into_both_packages_alike(jvars, tmp_path,
                                                 monkeypatch):
    params, stats = jvars
    layers = keras_layers(params, stats, np.random.default_rng(3), 1280,
                          extra=[("rescaling", {}), ("normalization", {})])
    check_h5(jeff2.load_keras_efficientnet_v2_weights,
             teff2.load_keras_efficientnet_v2_weights, params, stats, layers,
             tmp_path, monkeypatch)


def test_full_depth_has_keras_sizes():
    """``efficientnet_v2_b0``: Keras's ``EfficientNetV2B0(include_top=
    False)`` backbone, 5,858,704 trainable parameters and 60,608 BatchNorm
    statistics; the block counts and widths of the JAX tables for every
    variant."""
    model = teff2.EfficientNetV2(device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n - model.head.weight.numel() - 2 == 5_858_704
    assert sum(b.numel() for b in model.buffers()) == 60_608
    for name, (table, w, d) in teff2.VARIANTS.items():
        assert jeff2._VARIANTS[name] == (table, w, d)
        assert teff2.block_counts(name) == jeff2.block_counts(name)
        for row in teff2._STAGES[table]:
            assert teff2.round_filters_v2(row[3], w) == \
                jeff2.round_filters_v2(row[3], w)
    assert teff2._STAGES == jeff2._STAGES


@pytest.mark.parametrize("kernel", [1, 3, 5])
@pytest.mark.parametrize("side", [4, 5, 14, 15])
def test_same_pad_matches_flax_at_even_and_odd_sides(side, kernel):
    """``same_pad`` at strides 1 and 2 against Flax's ``"SAME"`` conv, and
    at stride 2 against Keras's ``correct_pad`` (EfficientNet v1's); the
    Xception pool that uses it against Flax's SAME max pool; on an even
    side at stride 2 the symmetric ``padding=k // 2`` gives the same shape
    and other values."""
    rng = np.random.default_rng(side * 10 + kernel)
    x = rng.standard_normal((2, side, side, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for stride in (1, 2):
        conv = fnn.Conv(4, (kernel, kernel), (stride, stride),
                        padding="SAME", use_bias=False)
        v = conv.init(jax.random.key(side), jnp.asarray(x))
        want = np.asarray(conv.apply(v, jnp.asarray(x)))
        mine = Conv(3, 4, kernel, stride, "same", "float32")
        mine.weight.data = torch.from_numpy(np.ascontiguousarray(
            np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)))
        with torch.no_grad():
            got = mine(xt)
            sym = torch.nn.functional.conv2d(xt, mine.weight, stride=stride,
                                             padding=kernel // 2)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-5, rtol=0)
        assert sym.shape == got.shape
        assert torch.allclose(sym, got, atol=1e-5) == (
            stride == 1 or kernel == 1 or side % 2 == 1)
        if stride == 2 and kernel > 1:
            assert same_pad(side, kernel, 2) == jeff._correct_pad(
                jnp.asarray(x), kernel)[0]
    pooled = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                          padding="SAME")
    np.testing.assert_array_equal(
        max_pool_same(xt).permute(0, 2, 3, 1).numpy(), np.asarray(pooled))

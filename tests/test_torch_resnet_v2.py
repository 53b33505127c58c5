"""The port's ResNet-V2 against the JAX package's on the CPU, with the same
weights carried across: a reduced-depth ``ResNetV2(depths=(2, 1, 1, 2))``
of both packages (every kind of block: a first block at stride 1 and at
stride 2, a later strided block with its ``::2`` shortcut, an identity
block in conv5) from one jitted JAX init, shared through a module-scoped
fixture; and the stem pool over zero padding."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import linen as fnn

from skin_image_analysis_tpu.models import resnet_v2 as jresnet_v2
from skin_image_analysis_tpu_torch.models import resnet_v2 as tresnet_v2
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

DEPTHS = (2, 1, 1, 2)
PAIR = Pair(
    "resnet50_v2",
    lambda dt: jresnet_v2.ResNetV2(depths=DEPTHS, head_dropout=0.0,
                                   compute_dtype=dt),
    lambda dt: tresnet_v2.ResNetV2(depths=DEPTHS, head_dropout=0.0,
                                   compute_dtype=dt))


@pytest.fixture(scope="module")
def jvars():
    return jax_variables(PAIR)


def conditioned(params, scale=0.2):
    """The last BatchNorm of each residual branch (``_2_bn``) at ``scale``
    of its random scale: with every branch at full scale a random net's
    train-mode gradient is ill-conditioned, as the ResNets' and
    Xception's are (measured: the float32 gradients of the two packages
    differ past 1e-5 + 1e-4 relative in 60 of 74 leaves; at 0.2, in
    none)."""
    return scaled_bns(params, {k for k in params if k.endswith("_2_bn")},
                      scale)


@pytest.mark.parametrize("side", [32, 37])
def test_forward_matches_jax(side, jvars):
    """32²: 16 -> 8 after the stem and pool, then 4, 2, 1; 37²: 19 -> 10,
    then 5, 3 (the ``::2`` shortcut of an odd side), 2."""
    check_forward(PAIR, *jvars, side)


def test_one_train_step_with_batch_stats_matches_jax(jvars):
    params, stats = jvars
    check_train_step(PAIR, conditioned(params), stats)


def test_bf16_gradient_matches_jax(jvars):
    """At 0.1 (:func:`conditioned`): at 0.2 JAX's own bf16 gradient lies at
    cosine 0.964 of its float32 gradient (measured), so that no
    implementation's could lie at 0.98 of it; at 0.1 JAX's lies at 0.983
    of its float32 gradient, and the port's at 0.984 of JAX's."""
    params, stats = jvars
    check_bf16_grad(PAIR, conditioned(params, 0.1), stats)


def test_bridge_round_trips(jvars):
    check_bridge(PAIR, *jvars)


def test_session_model_is_byte_equal_both_ways(jvars, tmp_path):
    check_session_model(PAIR, *jvars, tmp_path)


def test_keras_h5_loads_into_both_packages_alike(jvars, tmp_path,
                                                 monkeypatch):
    params, stats = jvars
    layers = keras_layers(params, stats, np.random.default_rng(3), 2048,
                          extra=[("probs", {})])
    check_h5(jresnet_v2.load_keras_resnet_v2_weights,
             tresnet_v2.load_keras_resnet_v2_weights, params, stats, layers,
             tmp_path, monkeypatch)


def test_full_depth_has_keras_sizes():
    """``resnet50_v2``: Keras's ``ResNet50V2(include_top=False)``,
    23,519,360 trainable parameters and 45,440 BatchNorm statistics; 49
    BatchNorms at epsilon 1.001e-5; a biased stem, ``_0_conv`` and
    ``_3_conv``, unbiased ``_1_conv`` and ``_2_conv``."""
    model = tresnet_v2.ResNetV2(device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n - model.head.weight.numel() - 2 == 23_519_360
    assert sum(b.numel() for b in model.buffers()) == 45_440
    bns = [m for m in model.modules() if isinstance(m, tresnet_v2.BatchNorm)]
    assert len(bns) == 49 and {bn.eps for bn in bns} == {1.001e-5}
    biased = {name.rsplit("_", 2)[-2] + "_" + name.rsplit("_", 1)[-1]
              for name, m in model.named_modules()
              if isinstance(m, tresnet_v2.Conv) and m.bias is not None}
    assert biased == {"conv1_conv", "0_conv", "3_conv"}


@pytest.mark.parametrize("side", [6, 7, 16])
def test_stem_pool_pads_zeros_as_keras_and_padding_1_would_not(side):
    """The stem pool over a zero padding equals the JAX module's; on
    all-negative activations ``max_pool2d(padding=1)``, which pads -inf,
    gives the same shape and other values on the border."""
    rng = np.random.default_rng(side)
    x = -np.abs(rng.standard_normal((2, 3, side, side))).astype(np.float32)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    want = np.asarray(fnn.max_pool(jresnet_v2._zero_pad(nhwc, 1), (3, 3),
                                   strides=(2, 2), padding="VALID"))
    got = tresnet_v2.stem_pool(torch.from_numpy(x))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    ninf = torch.nn.functional.max_pool2d(torch.from_numpy(x), 3, 2,
                                          padding=1)
    assert ninf.shape == got.shape and not torch.equal(ninf, got)
    assert float(got[:, :, 0, 0].max()) == 0.0 > float(ninf[:, :, 0, 0].max())

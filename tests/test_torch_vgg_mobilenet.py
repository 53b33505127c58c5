"""The port's VGG and MobileNetV2 against the JAX package's on the CPU,
with the same weights carried across: a VGG with one conv a block (the
full widths, 64 to 512, and all five pools) and a MobileNetV2 of the
first four stages of Keras's table (:data:`MOBILENET_STAGES`), each from
one jitted JAX init shared through a module-scoped fixture; the full
depths' Keras sizes; and MobileNetV2's stride-2 SAME geometry."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from skin_image_analysis_tpu.models import mobilenet as jmobilenet
from skin_image_analysis_tpu.models import vgg as jvgg
from skin_image_analysis_tpu_torch.models import mobilenet as tmobilenet
from skin_image_analysis_tpu_torch.models import vgg as tvgg
from skin_image_analysis_tpu_torch.models.resnet import Conv
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

ONE_CONV = (1, 1, 1, 1, 1)
PAIRS = {
    "vgg": Pair(
        "vgg16",
        lambda dt: jvgg.VGG(block_convs=ONE_CONV, head_dropout=0.0,
                            compute_dtype=dt),
        lambda dt: tvgg.VGG(block_convs=ONE_CONV, head_dropout=0.0,
                            compute_dtype=dt)),
    "mobilenet_v2": Pair(
        "mobilenet_v2",
        lambda dt: jmobilenet.MobileNetV2(head_dropout=0.0, compute_dtype=dt),
        lambda dt: tmobilenet.MobileNetV2(head_dropout=0.0,
                                          compute_dtype=dt)),
}
FAMILIES = list(PAIRS)
# Keras's first four stages (7 blocks, 3 of them adding): at the full 17
# blocks a random MobileNetV2's train-mode gradient is chaotic, in float32
# as in bf16 (measured: the two packages' float32 gradients at cosine
# 0.9999992 as a whole, and still past 1e-5 + 1e-4 relative in 111 of 158
# leaves, all upstream of one block; JAX's own gradient moves past it in
# 100 leaves when its input moves by 1e-6 relative)
MOBILENET_STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 2, 2),
                    (6, 64, 2, 2))


@contextlib.contextmanager
def stages(family):
    """Both packages' MobileNetV2 on :data:`MOBILENET_STAGES`, for the
    duration."""
    with pytest.MonkeyPatch.context() as mp:
        if family == "mobilenet_v2":
            for module in (jmobilenet, tmobilenet):
                mp.setattr(module, "_STAGES", MOBILENET_STAGES)
        yield


@pytest.fixture(scope="module")
def jvars():
    cache = {}

    def get(family):
        if family not in cache:
            with stages(family):
                cache[family] = jax_variables(PAIRS[family])
        return cache[family]

    return get


def conditioned(family, params):
    """MobileNetV2 with the last BatchNorm of each residual branch
    (``_project_BN`` of an adding block) at 0.1 of its random scale, as
    the ResNets' parity tests condition theirs (measured on
    :data:`MOBILENET_STAGES`: unconditioned, JAX's own bf16 gradient lies
    at cosine 0.944 of its float32 gradient, and the port's at 0.937 of
    JAX's; at 0.1, at 0.983 and 0.982, and the float32 gradients agree in
    every leaf); VGG has no residual branch."""
    if family != "mobilenet_v2":
        return params
    return scaled_bns(params, {"block_2_project_BN", "block_4_project_BN",
                               "block_6_project_BN"}, 0.1)


@pytest.mark.parametrize("side", [32, 37])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax(family, side, jvars):
    """32²: VGG pools 32 -> 16 -> 8 -> 4 -> 2 -> 1, MobileNetV2's four
    stride-2 convs pad 0 before and 1 after; 37²: VGG floors 37 -> 18 ->
    9 -> 4, MobileNetV2 pads 1 and 1 on 37, 19 and 5, 0 and 1 on 10."""
    with stages(family):
        check_forward(PAIRS[family], *jvars(family), side)


@pytest.mark.parametrize("family", FAMILIES)
def test_one_train_step_matches_jax(family, jvars):
    params, stats = jvars(family)
    with stages(family):
        check_train_step(PAIRS[family], conditioned(family, params), stats)


@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_gradient_matches_jax(family, jvars):
    params, stats = jvars(family)
    with stages(family):
        check_bf16_grad(PAIRS[family], conditioned(family, params), stats)


@pytest.mark.parametrize("family", FAMILIES)
def test_bridge_round_trips(family, jvars):
    with stages(family):
        check_bridge(PAIRS[family], *jvars(family))


@pytest.mark.parametrize("family", FAMILIES)
def test_session_model_is_byte_equal_both_ways(family, jvars, tmp_path):
    with stages(family):
        check_session_model(PAIRS[family], *jvars(family), tmp_path)


@pytest.mark.parametrize("family", FAMILIES)
def test_keras_h5_loads_into_both_packages_alike(family, jvars, tmp_path,
                                                 monkeypatch):
    params, stats = jvars(family)
    rng = np.random.default_rng(3)
    if family == "vgg":
        fc = [("flatten", {}),
              ("fc1", {"kernel": rng.standard_normal((512, 64)),
                       "bias": rng.standard_normal(64)})]
        loaders = (jvgg.load_keras_vgg_weights, tvgg.load_keras_vgg_weights)
    else:
        fc = [("Logits", {})]
        loaders = (jmobilenet.load_keras_mobilenet_v2_weights,
                   tmobilenet.load_keras_mobilenet_v2_weights)
    layers = keras_layers(params, stats, rng, 64 if family == "vgg" else 1280,
                          extra=fc)
    with stages(family):
        check_h5(*loaders, params, stats, layers, tmp_path, monkeypatch)


def test_full_depth_has_keras_sizes():
    """Keras's ``include_top=False`` trainable counts: VGG16 14,714,688 and
    VGG19 20,024,384 (13 and 16 biased convs); MobileNetV2 2,223,872 with
    34,112 BatchNorm statistics, 52 BatchNorms at epsilon 1e-3, 17
    depthwise convs and 10 adding blocks."""
    def trainable(model):
        return sum(p.numel() for p in model.parameters()) \
            - model.head.weight.numel() - 2

    for name, n in (("vgg16", 14_714_688), ("vgg19", 20_024_384)):
        model = tvgg.VGG(block_convs=tvgg.BLOCKS[name], device="meta")
        assert trainable(model) == n
        assert not list(model.buffers())
    model = tmobilenet.MobileNetV2(device="meta")
    assert trainable(model) == 2_223_872
    assert sum(b.numel() for b in model.buffers()) == 34_112
    bns = [m for m in model.modules() if isinstance(m, tmobilenet.BatchNorm)]
    assert len(bns) == 52 and {bn.eps for bn in bns} == {1e-3}
    assert sum(1 for m in model.modules()
               if isinstance(m, Conv) and m.groups > 1) == 17
    assert [p for p, _, adds in model.blocks if adds] == [
        f"block_{i}" for i in (2, 4, 5, 7, 8, 9, 11, 12, 14, 15)]


@pytest.mark.parametrize("side", [8, 9, 16, 17])
def test_stride2_same_conv_pads_as_keras_and_padding_1_would_not(side):
    """``Conv1`` (SAME) and a stride-2 depthwise conv (Keras's
    ``correct_pad`` + VALID) of the JAX module against the port's
    ``"same"`` conv; on an even side the symmetric ``padding=1`` gives the
    same shape and other values."""
    rng = np.random.default_rng(side)
    x = rng.standard_normal((2, side, side, 4)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for groups, pad in ((1, "SAME"),
                        (4, jmobilenet._correct_pad(jnp.asarray(x), 3))):
        conv = fnn.Conv(4, (3, 3), (2, 2), padding=pad,
                        feature_group_count=groups, use_bias=False)
        v = conv.init(jax.random.key(side), jnp.asarray(x))
        want = np.asarray(conv.apply(v, jnp.asarray(x)))
        mine = Conv(4, 4, 3, 2, "same", "float32", groups=groups)
        w = np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1)
        mine.weight.data = torch.from_numpy(np.ascontiguousarray(w))
        with torch.no_grad():
            got = mine(xt)
            sym = torch.nn.functional.conv2d(xt, mine.weight, stride=2,
                                             padding=1, groups=groups)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-5, rtol=0)
        assert sym.shape == got.shape
        assert torch.allclose(sym, got, atol=1e-5) == (side % 2 == 1)

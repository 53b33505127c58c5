"""The port's preprocess against the JAX package's, on the CPU.

The port's plain kernel twin is held against the JAX Pallas kernel run in
interpret mode, and the port's preprocess dispatch against the JAX
package's, with the JAX random draws replayed into the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from skin_image_analysis_tpu.ops import preprocess as jpre
from skin_image_analysis_tpu.ops.pallas import preprocess_kernel as jpk
from skin_image_analysis_tpu_torch.ops import preprocess as tpre
from skin_image_analysis_tpu_torch.ops.kernels import preprocess_kernel as tpk
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, N, S, T = 4, 7, 64, 48
MEAN = np.asarray(jpre.IMAGENET_MEAN, np.float32)
STD = np.asarray(jpre.IMAGENET_STD, np.float32)


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(seed, tail):
    rng = np.random.default_rng(seed)
    arena = rng.integers(0, 256, (N, 3, S, S), dtype=np.uint8)
    rows = rng.permutation(N)[:B].astype(np.int32)
    offsets = rng.integers(0, S - T + 1, (B, 2)).astype(np.int32)
    flips = np.array([0, 1, 1, 0], np.int32)
    bright = rng.uniform(0.9, 1.1, (B, 1)).astype(np.float32)
    if tail:
        scale = np.tile(np.float32(1 / 255), (B, 3)) * bright
        bias = np.zeros((B, 3), np.float32)
        extra = (rng.uniform(0.8, 1.2, B).astype(np.float32),
                 rng.uniform(0.8, 1.2, B).astype(np.float32),
                 np.tile(1 / STD, (B, 1)).astype(np.float32),
                 np.tile(-MEAN / STD, (B, 1)).astype(np.float32))
    else:
        scale = (np.tile(1 / 255 / STD, (B, 1)) * bright).astype(np.float32)
        bias = np.tile(-MEAN / STD, (B, 1)).astype(np.float32)
        extra = (None,) * 4
    return arena, offsets, flips, scale, bias, rows, *extra


def _run_both(args, out_dtype, s2d):
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    want = jpk.fused_preprocess_planar(
        *jargs, image_size=T, out_dtype=getattr(jnp, out_dtype),
        space_to_depth=s2d)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    got = tpk.fused_preprocess_planar(
        *targs, image_size=T, out_dtype=getattr(torch, out_dtype),
        space_to_depth=s2d)
    return np.asarray(want, np.float32), got.float().numpy()


@pytest.mark.parametrize("tail,out_dtype,s2d,atol", [
    (False, "float32", False, 1e-6),
    (True, "float32", False, 1e-5),
    (True, "bfloat16", False, 2e-2),
    (False, "float32", True, 1e-6),
    (True, "float32", True, 1e-5),
    (True, "bfloat16", True, 2e-2),
])
def test_kernel_twin_matches_pallas(tail, out_dtype, s2d, atol):
    """No-tail f32 to 1e-6 (the same two roundings); the tail's mean is
    summed in another order (1e-5). JAX runs the bf16 tail in bf16, which
    puts its output up to ~0.06 from its own f32 tail (bf16 post-affine
    constants, five roundings), while the port rounds once: the port's
    bf16 holds to 2e-2 of JAX's f32 tail, the reference the JAX kernel
    names, and to JAX's bf16 output within JAX's own bf16 error plus
    2e-2."""
    args = _inputs(3, tail)
    want, got = _run_both(args, out_dtype, s2d)
    assert got.shape == want.shape
    assert got.shape == ((B, 12, T // 2, T // 2) if s2d else (B, 3, T, T))
    if out_dtype == "bfloat16":
        ref, _ = _run_both(args, "float32", s2d)
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
        assert (np.abs(got - want) <= np.abs(want - ref) + atol).all()
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_twin_gathers_rows_and_flips():
    """Arena row, crop and flip semantics of the twin, from first
    principles."""
    arena, offsets, flips, scale, bias, rows, *_ = _inputs(5, False)
    got = tpk.fused_preprocess_planar_ref(
        *(torch.from_numpy(a) for a in (arena, offsets, flips, scale, bias,
                                        rows)), image_size=T).numpy()
    for i in range(B):
        y0, x0 = offsets[i]
        tile = arena[rows[i], :, y0:y0 + T, x0:x0 + T].astype(np.float32)
        if flips[i]:
            tile = tile[:, :, ::-1]
        want = tile * scale[i][:, None, None] + bias[i][:, None, None]
        np.testing.assert_array_equal(got[i], want)


# (crop, channels, space_to_depth, tail): the train step's shapes, the
# card tests' edge shapes, crops whose bands must be cut finer to fit, and
# tailed crops too large for one cluster (the sums launch)
PLAN_SHAPES = [(224, 3, False, True), (224, 3, True, True),
               (224, 3, False, False), (50, 3, False, True),
               (50, 3, True, True), (31, 3, False, True), (32, 1, False, False),
               (32, 3, True, True), (3, 3, False, True), (2, 3, True, True),
               (512, 3, False, True), (1024, 3, False, False),
               (1024, 8, True, False), (769, 3, False, True),
               (770, 3, False, True), (1024, 3, False, True),
               (1024, 3, True, True), (2047, 3, False, True),
               (2048, 3, True, True), (4200, 3, False, True)]


@pytest.mark.parametrize("blocks", [None, 1, 2, 4, 8])
@pytest.mark.parametrize("crop,channels,s2d,tail", PLAN_SHAPES)
def test_band_plan_covers_every_crop_row_once(crop, channels, s2d, tail,
                                              blocks):
    """The kernel's bands: each crop row in exactly one, none empty, whole
    output rows with s2d, with the tail a cluster of at most 8 or else the
    sums launch, and the band within a block's 227 KB of shared memory."""
    plan = tpk.band_plan(crop, channels, space_to_depth=s2d, tail=tail,
                         blocks=blocks)
    k, rows, pitch, smem = plan[:4]
    owner = np.zeros(crop, int)
    for r in range(k):
        lo, hi = r * rows, min((r + 1) * rows, crop)
        assert hi > lo
        owner[lo:hi] += 1
    assert (owner == 1).all()
    assert not s2d or rows % 2 == 0
    assert plan.sums_launch == (tail and k > tpk.MAX_CLUSTER)
    assert pitch % 16 == 0 and pitch >= crop + 15
    assert channels * rows * pitch + 16 <= smem <= 227 * 1024 - 1024


def test_band_plan_refuses_a_tail_too_large_for_one_cluster():
    """A tailed crop whose bands do not fit one cluster of 8 (above 769
    px, 768 with s2d) is refused by the clustered form and planned as the
    sums launch; up to there the clustered form holds, and a crop too
    large for any band still raises."""
    for s2d in (False, True):
        for crop in (770, 1024, 2048):
            plan = tpk.band_plan(crop, 3, space_to_depth=s2d, tail=True)
            assert plan.sums_launch and plan.blocks > tpk.MAX_CLUSTER
            assert plan.blocks * plan.band_rows >= crop
        assert not tpk.band_plan(768, 3, space_to_depth=s2d,
                                 tail=True).sums_launch
    assert tpk.band_plan(1024, 3, tail=True).blocks == 16
    assert not tpk.band_plan(769, 3, tail=True).sums_launch
    with pytest.raises(ValueError, match="shared memory"):
        tpk.band_plan(80000, 3, tail=True)


def test_wrapper_rejects_mismatched_tail_arguments():
    arena, offsets, flips, scale, bias, rows, fc, *_ = _inputs(1, True)
    t = [torch.from_numpy(a) for a in (arena, offsets, flips, scale, bias,
                                       rows, fc)]
    with pytest.raises(ValueError, match="go together"):
        tpk.fused_preprocess_planar(*t, image_size=T)


def _jax_planar_draws(key, b, s, t, augment):
    """The draws JAX's preprocess_planar_batch makes from ``key``."""
    ky, kx, kf, kb, kc, ks = jax.random.split(key, 6)
    ys = jax.random.randint(ky, (b,), 0, s - t + 1, dtype=jnp.int32)
    xs = jax.random.randint(kx, (b,), 0, s - t + 1, dtype=jnp.int32)
    flips = jax.random.bernoulli(kf, 0.5, (b,)).astype(jnp.int32)

    def factor(k, half, shape):
        if half <= 0:
            return None
        f = jax.random.uniform(k, shape, minval=1 - half, maxval=1 + half)
        return torch.from_numpy(np.array(f).reshape(b))

    if not augment.random_crop:
        ys = xs = jnp.full((b,), (s - t) // 2, jnp.int32)
    if not augment.horizontal_flip:
        flips = jnp.zeros((b,), jnp.int32)
    return tpre.AugmentDraws(
        torch.from_numpy(np.stack([np.asarray(ys), np.asarray(xs)], 1)),
        torch.from_numpy(np.array(flips)),
        factor(kb, augment.brightness, (b, 1)),
        factor(kc, augment.contrast, (b,)),
        factor(ks, augment.saturation, (b,)))


@pytest.mark.parametrize("augment,norm,out_dtype,atol", [
    (jpre.AugmentConfig(brightness=0.2, contrast=0.2, saturation=0.2),
     True, None, 1e-5),
    (jpre.AugmentConfig(brightness=0.2, contrast=0.2, saturation=0.2),
     True, "bfloat16", 2e-2),
    (jpre.AugmentConfig(), True, None, 1e-5),
    (jpre.AugmentConfig(horizontal_flip=False, contrast=0.3), False, None,
     1e-5),
])
def test_planar_dispatch_matches_jax(augment, norm, out_dtype, atol):
    """The port's planar train path (kernel, per-image affine folding,
    in-kernel jitter tail) against the JAX package's on replayed draws."""
    rng = np.random.default_rng(11)
    arena = rng.integers(0, 256, (N, 3, S, S), dtype=np.uint8)
    rows = np.array([6, 0, 3, 3], np.int32)
    key = jax.random.key(4)
    # bf16 is held to JAX's f32 tail, as in test_kernel_twin_matches_pallas
    want = jpk.preprocess_planar_batch(
        jnp.asarray(arena), key, image_size=T, train=True, augment=augment,
        normalize_imagenet=norm, rows=jnp.asarray(rows))
    draws = _jax_planar_draws(key, B, S, T, augment)
    got = tpre.preprocess_planar_batch(
        torch.from_numpy(arena), image_size=T, train=True,
        augment=tpre.AugmentConfig(*augment), normalize_imagenet=norm,
        rows=torch.from_numpy(rows), draws=draws,
        out_dtype=None if out_dtype is None else getattr(torch, out_dtype))
    assert got.shape == (B, T, T, 3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("augment,channels", [
    (jpre.AugmentConfig(brightness=0.2, contrast=0.2, saturation=0.2), 3),
    (jpre.AugmentConfig(), 3),
    (jpre.AugmentConfig(brightness=0.2, contrast=0.3), 1),
])
def test_planar_dispatch_s2d_matches_jax(augment, channels):
    """With space_to_depth the kernel stores the s2d stem's layout
    ([B, T/2, T/2, 12] after the permute), as in the JAX package; a
    one-channel arena keeps the plain layout, which the model transforms."""
    rng = np.random.default_rng(13)
    arena = rng.integers(0, 256, (N, channels, S, S), dtype=np.uint8)
    rows = np.array([1, 4, 4, 0], np.int32)
    norm = channels == 3
    key = jax.random.key(9)
    want = jpk.preprocess_planar_batch(
        jnp.asarray(arena), key, image_size=T, train=True, augment=augment,
        normalize_imagenet=norm, rows=jnp.asarray(rows),
        space_to_depth=True)
    got = tpre.preprocess_planar_batch(
        torch.from_numpy(arena), image_size=T, train=True,
        augment=tpre.AugmentConfig(*augment), normalize_imagenet=norm,
        rows=torch.from_numpy(rows),
        draws=_jax_planar_draws(key, B, S, T, augment), space_to_depth=True)
    shape = (B, T // 2, T // 2, 12) if channels == 3 else (B, T, T, 1)
    assert got.shape == tuple(want.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_planar_dispatch_one_channel_matches_jax():
    """A one-channel arena: the kernel runs without its tail and the
    brightness-contrast jitter runs in plain tensor code after it, as in
    the JAX package."""
    rng = np.random.default_rng(12)
    arena = rng.integers(0, 256, (N, 1, S, S), dtype=np.uint8)
    rows = np.array([2, 5, 0, 2], np.int32)
    augment = jpre.AugmentConfig(brightness=0.2, contrast=0.3)
    key = jax.random.key(7)
    want = jpk.preprocess_planar_batch(
        jnp.asarray(arena), key, image_size=T, train=True, augment=augment,
        rows=jnp.asarray(rows))
    got = tpre.preprocess_planar_batch(
        torch.from_numpy(arena), image_size=T, train=True,
        augment=tpre.AugmentConfig(*augment), rows=torch.from_numpy(rows),
        draws=_jax_planar_draws(key, B, S, T, augment))
    assert got.shape == (B, T, T, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_eval_resize_matches_jax():
    """Eval 64 -> 48 is an antialiased bilinear resize in both."""
    rng = np.random.default_rng(2)
    pixels = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    want = jpre.preprocess_batch(jnp.asarray(pixels), image_size=T,
                                 normalize_imagenet=True)
    got = tpre.preprocess_batch(torch.from_numpy(pixels), image_size=T,
                                normalize_imagenet=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_planar_eval_resizes_instead_of_cropping():
    """Eval on a planar arena larger than the target takes the resize
    path, like JAX's kernel_crop_ok rule."""
    rng = np.random.default_rng(8)
    arena = rng.integers(0, 256, (N, 3, S, S), dtype=np.uint8)
    want = jpre.preprocess_batch(
        jnp.asarray(arena.transpose(0, 2, 3, 1)), image_size=T)
    fn = tpre.make_preprocess_fn(T, train=False, layout="planar")
    got = fn(torch.from_numpy(arena))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_train_resize_path_matches_jax():
    """random_crop=False with S != T: the reference resize semantics, with
    flip and jitter, replayed from JAX's preprocess_batch draws."""
    rng = np.random.default_rng(9)
    pixels = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    augment = jpre.AugmentConfig(random_crop=False, brightness=0.2,
                                 contrast=0.2, saturation=0.2)
    key = jax.random.key(6)
    want = jpre.preprocess_batch(jnp.asarray(pixels), key, image_size=T,
                                 train=True, augment=augment)
    key, sub = jax.random.split(key)
    flips = jax.random.bernoulli(sub, 0.5, (B, 1, 1, 1)).reshape(B)
    key, sub = jax.random.split(key)
    kb, kc, ks = jax.random.split(sub, 3)

    def factor(k):
        f = jax.random.uniform(k, (B, 1, 1, 1), minval=0.8, maxval=1.2)
        return torch.from_numpy(np.array(f).reshape(B))

    draws = tpre.AugmentDraws(
        torch.zeros((B, 2), dtype=torch.int32),
        torch.from_numpy(np.asarray(flips).astype(np.int32)),
        factor(kb), factor(kc), factor(ks))
    got = tpre.preprocess_batch(
        torch.from_numpy(pixels), image_size=T, train=True,
        augment=tpre.AugmentConfig(*augment), draws=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_normalize_and_affine_are_exclusive():
    with pytest.raises(ValueError, match="exclusive"):
        tpre.make_preprocess_fn(T, train=False, normalize_imagenet=True,
                                input_affine=(1.0, 0.0))

"""The port's fused ReLU + pool ops against the JAX package's, in float32
on the CPU. Inputs are small integers, so every sum is exact, ties and
negative windows are common, and the selectors must be equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu.ops import pooling as jpool
from skin_image_analysis_tpu_torch.ops import pooling as tpool


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a module: the suite's workers share
    the CPU, and with torch's default pool in each of them the port's ops
    slow down by 20-150x (measured on 8 cores). The port's test modules
    import it and use it on all their tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (2, 7, 9, 4), (1, 5, 5, 2)])
def test_relu_max_pool_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-3, 4, shape).astype(np.float32)
    x[0, :2, :2, 0] = -1.0  # one ReLU-dead window
    x[0, :2, 2:4, 0] = 2.0  # one window of four tied maxima
    y_j, vjp = jax.vjp(jpool.relu_max_pool_2x2, jnp.asarray(x))
    _, sel_j = jpool._relu_pool_fwd_impl(jnp.asarray(x))
    g = rng.normal(size=y_j.shape).astype(np.float32)
    (dx_j,) = vjp(jnp.asarray(g))

    xt = _nchw(x).requires_grad_(True)
    y_t = tpool.relu_max_pool_2x2(xt)
    y_t.backward(_nchw(g))
    np.testing.assert_array_equal(
        _nhwc(tpool.relu_max_pool_2x2_selector(_nchw(x))), np.asarray(sel_j))
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx_j), atol=1e-5)
    assert (np.asarray(sel_j) == 4).any()  # dead windows were exercised


def test_relu_max_phase_matches_jax():
    rng = np.random.default_rng(3)
    y4 = rng.integers(-2, 3, (2, 5, 6, 4 * 3)).astype(np.float32)
    y_j, vjp = jax.vjp(jpool.relu_max_phase, jnp.asarray(y4))
    _, sel_j = jpool._phase_fwd_impl(jnp.asarray(y4))
    g = rng.normal(size=y_j.shape).astype(np.float32)
    (dy_j,) = vjp(jnp.asarray(g))

    yt = _nchw(y4).requires_grad_(True)
    out = tpool.relu_max_phase(yt)
    out.backward(_nchw(g))
    np.testing.assert_array_equal(
        _nhwc(tpool.relu_max_phase_selector(_nchw(y4))), np.asarray(sel_j))
    np.testing.assert_allclose(_nhwc(out), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(_nhwc(yt.grad), np.asarray(dy_j), atol=1e-5)


def test_phase_pack_kernel_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 3, 2, 4)).astype(np.float32)  # HWIO
    want = np.asarray(jpool.phase_pack_kernel(jnp.asarray(w)))
    got = tpool.phase_pack_kernel(
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


@pytest.mark.parametrize("k,cin,cout", [(7, 3, 4), (3, 2, 5)])
def test_phase_packed_conv_block_matches_jax(k, cin, cout):
    rng = np.random.default_rng(k)
    x = rng.integers(-2, 3, (2, 10, 8, cin)).astype(np.float32)
    w = rng.integers(-1, 2, (k, k, cin, cout)).astype(np.float32)
    b = rng.integers(-1, 2, (cout,)).astype(np.float32)
    y_j, vjp = jax.vjp(jpool.phase_packed_conv_block, jnp.asarray(x),
                       jnp.asarray(w), jnp.asarray(b))
    g = rng.normal(size=y_j.shape).astype(np.float32)
    dx_j, dw_j, db_j = vjp(jnp.asarray(g))

    xt = _nchw(x).requires_grad_(True)
    wt = torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1))).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y_t = tpool.phase_packed_conv_block(xt, wt, bt)
    y_t.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx_j), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(dw_j), atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_j), atol=1e-5)

    # the packed block is conv(SAME) + bias + ReLU + 2x2 max-pool
    conv = torch.nn.functional.conv2d(_nchw(x), wt.detach(), bt.detach(),
                                      padding="same")
    pooled = torch.nn.functional.max_pool2d(torch.relu(conv), 2, 2)
    np.testing.assert_array_equal(y_t.detach().numpy(), pooled.numpy())


@pytest.mark.parametrize("fn", ["max_pool_2x2", "max_pool_2x2_hybrid"])
@pytest.mark.parametrize("shape", [(2, 8, 6, 3), (2, 7, 9, 4)])
def test_max_pool_2x2_matches_jax(fn, shape):
    """Forward and the equality-mask backward (every tied maximum gets the
    full cotangent; a cropped odd row or column gets none)."""
    rng = np.random.default_rng(sum(shape) + len(fn))
    x = rng.integers(-3, 4, shape).astype(np.float32)
    x[0, :2, :2, 0] = 2.0  # one window of four tied maxima
    y_j, vjp = jax.vjp(getattr(jpool, fn), jnp.asarray(x))
    g = rng.normal(size=y_j.shape).astype(np.float32)
    (dx_j,) = vjp(jnp.asarray(g))

    xt = _nchw(x).requires_grad_(True)
    y_t = getattr(tpool, fn)(xt)
    y_t.backward(_nchw(g))
    np.testing.assert_array_equal(_nhwc(y_t), np.asarray(y_j))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx_j), atol=1e-6)


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(6).normal(size=(2, 6, 8, 3)).astype(np.float32)
    want = np.asarray(jpool.space_to_depth_nhwc(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(tpool.space_to_depth(_nchw(x))),
                                  want)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("k", [7, 3, 5])
def test_s2d_pack_kernel_matches_jax(k):
    w = np.random.default_rng(k).normal(size=(k, k, 3, 4)).astype(np.float32)
    want = np.asarray(jpool.s2d_pack_kernel(jnp.asarray(w)))
    got = tpool.s2d_pack_kernel(_oihw(w))
    np.testing.assert_array_equal(got.numpy().transpose(2, 3, 1, 0), want)


@pytest.mark.parametrize("k", [7, 3])
def test_s2d_conv_block_matches_jax(k):
    """Small integers: every sum is exact, the selectors equal."""
    rng = np.random.default_rng(10 + k)
    x = rng.integers(-2, 3, (2, 12, 10, 3)).astype(np.float32)
    z = np.asarray(jpool.space_to_depth_nhwc(jnp.asarray(x)))
    w = rng.integers(-1, 2, (k, k, 3, 4)).astype(np.float32)
    b = rng.integers(-1, 2, (4,)).astype(np.float32)
    y_j, vjp = jax.vjp(jpool.s2d_conv_block, jnp.asarray(z), jnp.asarray(w),
                       jnp.asarray(b))
    g = rng.normal(size=y_j.shape).astype(np.float32)
    dz_j, dw_j, db_j = vjp(jnp.asarray(g))

    zt = _nchw(z).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y_t = tpool.s2d_conv_block(zt, wt, bt)
    y_t.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(y_t), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(_nhwc(zt.grad), np.asarray(dz_j), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0),
                               np.asarray(dw_j), atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_j), atol=1e-5)


@pytest.mark.parametrize("k", [7, 3, 5])
def test_s2d_conv_block_equals_phase_packed(k):
    """The s2d block on space_to_depth(x) is the phase-packed block on x:
    outputs and weight/bias gradients in float32 within 1e-5 (of the
    largest gradient magnitude for the gradients)."""
    rng = np.random.default_rng(20 + k)
    x = torch.from_numpy(rng.normal(size=(2, 3, 16, 16)).astype(np.float32))
    w0 = torch.from_numpy((rng.normal(size=(4, 3, k, k)) * 0.1).astype(
        np.float32))
    b0 = torch.from_numpy((rng.normal(size=4) * 0.1).astype(np.float32))
    outs = []
    for fn, inp in ((tpool.s2d_conv_block, tpool.space_to_depth(x)),
                    (tpool.phase_packed_conv_block, x)):
        w, b = w0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        y = fn(inp, w, b)
        (y ** 2).sum().backward()
        outs.append((y.detach(), w.grad, b.grad))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * max(want.abs().max(), 1.0))

"""The port's fused phase-conv0 (plain versions of the CUDA kernels and the
autograd Function around them) against the JAX package's Pallas kernel in
interpret mode and against the unfused phase-packed block, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu.ops.pallas import convblock_kernel as jck
from skin_image_analysis_tpu_torch.ops import pooling as tpool
from skin_image_analysis_tpu_torch.ops.kernels import convblock_kernel as tck
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((7, 7, 3, 32)) * 0.2).astype(np.float32)  # HWIO
    b = np.linspace(-0.05, 0.05, 32).astype(np.float32)
    return x, w, b


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _bf16_ulp(v):
    """One bf16 ulp of each value (at least 1e-5, for values near 0 whose
    float32 sums may differ in the tail before the rounding)."""
    _, e = np.frexp(np.abs(v).astype(np.float64))
    return np.maximum(np.ldexp(1.0, e - 8), 1e-5)


def _top_two_gap(x, w, b):
    """Per (image, co, position): the float64 gap between the largest and
    second largest packed phase outputs, and the largest itself, from the
    bf16-rounded inputs."""
    xb = torch.from_numpy(x).to(torch.bfloat16).double()
    wp = tpool.phase_pack_kernel(_oihw(w).to(torch.bfloat16).double())
    y4 = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xb, (3, 4, 3, 4)), wp, stride=2)
    y4 = y4 + torch.from_numpy(b).double().repeat(4)[None, :, None, None]
    yr = y4.view(y4.shape[0], 4, 32, *y4.shape[2:])
    top = yr.topk(2, dim=1).values
    return (top[:, 0] - top[:, 1]).numpy(), top[:, 0].numpy()


@pytest.mark.parametrize("shape,seed", [((2, 3, 16, 16), 0),
                                        ((1, 3, 24, 24), 2)])
def test_plain_forward_matches_pallas(shape, seed):
    """Pooled values within one bf16 ulp of the Pallas kernel's; selectors
    equal except where the top two phases tie within float32 rounding
    (gap <= 1e-5) or the maximum is within 1e-5 of 0."""
    x, w, b = _inputs(shape, seed)
    y_j, sel_j = jck._fused_fwd_impl(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))
    h2, w2 = shape[2] // 2, shape[3] // 2
    y_j = np.asarray(y_j, np.float32).transpose(0, 3, 1, 2)
    sel_j = np.asarray(sel_j)[..., :w2]

    wp2 = tck._pack_w(_oihw(w))
    pooled, sel = tck.fused_phase_conv0_ref(
        torch.from_numpy(x), wp2, torch.from_numpy(b).repeat(4))
    assert pooled.dtype == torch.bfloat16 and sel.dtype == torch.uint8
    assert pooled.shape == sel.shape == (shape[0], 32, h2, w2)
    got = pooled.float().numpy()
    assert (np.abs(got - y_j) <= _bf16_ulp(y_j)).all()
    gap, top = _top_two_gap(x, w, b)
    differ = sel.numpy() != sel_j
    assert (sel_j == 4).any() and (sel_j < 4).any()
    assert ((gap <= 1e-5) | (np.abs(top) <= 1e-5))[differ].all()
    assert differ.mean() < 1e-2


def _grads(fn, x, w, b, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = fn(xt, wt, bt)
    y.backward(g.to(y.dtype))
    return y, xt.grad, wt.grad, bt.grad


def test_autograd_matches_pallas_vjp():
    """dx, dW and db of the autograd Function against JAX's custom VJP on
    the same bf16 cotangent: float32 sums in another order, so rtol 1e-4
    with atol 1e-4 of each gradient's largest magnitude."""
    x, w, b = _inputs((2, 3, 16, 16), 1)
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.standard_normal((2, 32, 8, 8)).astype(
        np.float32)).to(torch.bfloat16)
    _, vjp = jax.vjp(jck.fused_phase_conv0, jnp.asarray(x), jnp.asarray(w),
                     jnp.asarray(b))
    g_nhwc = jnp.asarray(g.float().numpy().transpose(0, 2, 3, 1),
                         jnp.bfloat16)
    dx_j, dw_j, db_j = (np.asarray(a, np.float32) for a in vjp(g_nhwc))

    _, dx, dw, db = _grads(tck.fused_phase_conv0, x, w, b, g)
    for got, want in ((dx.numpy(), dx_j),
                      (dw.numpy().transpose(2, 3, 1, 0), dw_j),
                      (db.numpy(), db_j)):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def test_autograd_matches_unfused_block():
    """dx, dW and db of sum(y^2) against the unfused float32
    phase_packed_conv_block: cosine > 0.999 and, scaled by the largest
    reference magnitude, within 8e-2 (the JAX kernel test's bounds; the
    fused path rounds x, w and y to bf16, so a pool window whose top two
    phases nearly tie can route its gradient elsewhere: on these inputs
    the largest scaled dW error is 0.037, the JAX kernel's the same)."""
    x, w, b = _inputs((2, 3, 16, 16), 5)

    def loss_grad(fn):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = _oihw(w).requires_grad_(True)
        bt = torch.from_numpy(b).requires_grad_(True)
        (fn(xt, wt, bt).float() ** 2).sum().backward()
        return xt.grad, wt.grad, bt.grad

    fused = loss_grad(tck.fused_phase_conv0)
    plain = loss_grad(tpool.phase_packed_conv_block)
    for a, bb, name in zip(fused, plain, ("dx", "dw", "db")):
        na, nb = a.numpy(), bb.numpy()
        assert _cos(na, nb) > 0.999, name
        scale = max(np.abs(nb).max(), 1e-3)
        np.testing.assert_allclose(na / scale, nb / scale, atol=8e-2,
                                   err_msg=name)


def test_dx_only_when_asked():
    """Parameter-only training needs no dx: x without requires_grad gets
    none, while w and bias do."""
    x, w, b = _inputs((1, 3, 8, 8), 4)
    wt = _oihw(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = tck.fused_phase_conv0(torch.from_numpy(x), wt, bt)
    dw, db = torch.autograd.grad(y.float().sum(), (wt, bt))
    assert dw.shape == wt.shape and db.shape == bt.shape


def test_plain_dw_matches_pallas_partials():
    """The dW plain version's per-image partials against the Pallas dW
    kernel's, on the same bf16 x, cotangent and selector."""
    x, w, b = _inputs((2, 3, 16, 16), 6)
    _, sel_j = jck._fused_fwd_impl(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))
    rng = np.random.default_rng(7)
    g = rng.standard_normal((2, 32, 8, 8)).astype(np.float32)
    gp = jnp.pad(jnp.asarray(g, jnp.bfloat16), ((0, 0),) * 3 + ((0, 120),))
    want = np.asarray(jck._dw_call(jck.space_to_depth(jnp.asarray(x)), gp,
                                   sel_j, chunk=8))
    got = tck.fused_phase_conv0_dw_ref(
        torch.from_numpy(x).to(torch.bfloat16),
        torch.from_numpy(g).to(torch.bfloat16),
        torch.from_numpy(np.asarray(sel_j)[..., :8].copy()))
    assert got.shape == (2, 128, 192) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_pack_and_unpack_match_jax():
    rng = np.random.default_rng(8)
    w = rng.standard_normal((7, 7, 3, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        tck._pack_w(_oihw(w)).float().numpy(),
        np.asarray(jck._pack_w(jnp.asarray(w)), np.float32))
    d = rng.standard_normal((128, 192)).astype(np.float32)
    np.testing.assert_allclose(
        tck._unpack_dw(torch.from_numpy(d)).numpy().transpose(2, 3, 1, 0),
        np.asarray(jck._unpack_dw(jnp.asarray(d))), rtol=1e-6, atol=1e-6)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """CPU tensors take the plain versions and count no launch."""
    x, w, b = _inputs((1, 3, 8, 8), 9)
    fwd, dw = tck.fused_phase_conv0_fwd, tck.fused_phase_conv0_dw
    before = (fwd.launches, dw.launches)
    args = (torch.from_numpy(x), tck._pack_w(_oihw(w)),
            torch.from_numpy(b).repeat(4))
    pooled, sel = fwd(*args)
    want = tck.fused_phase_conv0_ref(*args)
    assert torch.equal(pooled, want[0]) and torch.equal(sel, want[1])
    g = torch.ones_like(pooled)
    xb = args[0].to(torch.bfloat16)
    assert torch.equal(dw(xb, g, sel),
                       tck.fused_phase_conv0_dw_ref(xb, g, sel))
    assert (fwd.launches, dw.launches) == before


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("h,w", [(16, 16), (24, 24), (36, 18), (66, 40),
                                 (34, 32), (224, 224), (2, 2), (1024, 1024),
                                 (1280, 1280)])
def test_dw_plan_gives_every_pooled_row_one_block(h, w, cluster):
    """The dW kernel's plan: the blocks of an image take contiguous shares
    of whole bands (the last may be ragged or empty) that cover every
    pooled row exactly once, and a block's shared memory (the larger of
    the staging and the reduction tile) stays within 227 KB."""
    plan = tck.dw_plan(w, 256, 132)._replace(cluster=cluster)
    owner = np.zeros(h // 2, int)
    hi_prev = 0
    for lo, hi in plan.shares(h // 2):
        assert lo == hi_prev and lo <= hi
        assert lo % plan.band_rows == 0
        owner[lo:hi] += 1
        hi_prev = hi
    assert (owner == 1).all()
    assert plan.smem_bytes == tck.dw_smem_bytes(plan.band_rows, w)
    assert 4 * 128 * 196 <= plan.smem_bytes <= 227 * 1024 - 1024


def test_dw_plan_at_224_holds_two_blocks_an_sm():
    """At the rig's 224 two blocks of 256 threads (16 warps) fit an SM's
    228 KB of shared memory with its 1 KB reserve a block; on 132 SMs the
    cluster is the most blocks an image, up to 8, that keep the grid
    within one block an SM; a plan of a cluster size the kernel does not
    take and widths whose band does not fit raise."""
    plan = tck.dw_plan(224, 256, 132)
    assert (plan.cluster, plan.band_rows) == (1, tck.DW_ROWS)
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024
    assert [tck.dw_plan(224, b, 132).cluster
            for b in (1, 16, 17, 33, 34, 64, 66, 67, 132, 256)] == [
                8, 8, 4, 4, 2, 2, 2, 1, 1, 1]
    xb = torch.zeros(1, 3, 4, 4, dtype=torch.bfloat16)
    g = torch.zeros(1, 32, 2, 2, dtype=torch.bfloat16)
    sel = torch.zeros(1, 32, 2, 2, dtype=torch.uint8)
    with pytest.raises(ValueError, match="cluster"):
        tck.fused_phase_conv0_dw(xb, g, sel, plan._replace(cluster=3))
    with pytest.raises(ValueError, match="shared memory"):
        tck.dw_plan(4096, 256, 132)


@pytest.mark.parametrize("rows", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("b,h,w,sms", [(256, 224, 224, 132), (16, 224, 224, 132),
                                       (1, 224, 224, 132), (3, 36, 18, 132),
                                       (2, 66, 40, 5), (5, 42, 32, 3),
                                       (1, 2, 2, 132), (7, 1024, 1024, 132)])
def test_fwd_plan_gives_every_pooled_row_of_every_image_one_tile(b, h, w, sms,
                                                                  rows):
    """The forward kernel's plan: its persistent blocks (at most one a
    tile) take contiguous ranges of image-major tiles that cover every
    pooled row of every image exactly once, and a block's shared memory
    stays within 227 KB."""
    plan = tck.fwd_plan(w, b, sms)._replace(band_rows=rows)
    h2 = h // 2
    grid = plan.grid(b, h2, sms)
    t = plan.tiles(b, h2)
    assert 1 <= grid <= min(t, plan.blocks_per_sm * sms)
    # the kernel's split: block g takes tiles [g*t/grid, (g+1)*t/grid) in
    # image-major order, tile i = (image i // nb, rows from i % nb * rows)
    nb = -(-h2 // rows)
    per_block = [[(i // nb, i % nb * rows, min((i % nb + 1) * rows, h2))
                  for i in range(g * t // grid, (g + 1) * t // grid)]
                 for g in range(grid)]
    assert all(per_block)
    flat = [t for tiles in per_block for t in tiles]
    assert flat == sorted(flat)  # contiguous ranges, image-major
    owner = np.zeros((b, h2), int)
    for img, lo, hi in flat:
        assert lo % rows == 0 and lo < hi <= h2
        owner[img, lo:hi] += 1
    assert (owner == 1).all()
    assert tck.fwd_plan(w, b, sms).smem_bytes <= 227 * 1024 - 1024


def test_fwd_plan_at_224_takes_16_rows_and_one_block_an_sm():
    """At the rig's 224 a tile of 16 pooled rows fits a block's 227 KB, and
    one block of two warpgroups takes an SM (its registers allow no
    second); the grid is one block an SM. Wider images take fewer rows a
    tile; widths whose band does not fit and a plan without rows raise."""
    plan = tck.fwd_plan(224, 256, 132)
    assert (plan.band_rows, plan.blocks_per_sm) == (tck.FWD_ROWS, 1)
    assert plan.smem_bytes == tck.fwd_smem_bytes(tck.FWD_ROWS, 224)
    assert plan.smem_bytes <= tck.SMEM_LIMIT
    assert plan.grid(256, 112, 132) == 132
    assert plan.grid(1, 112, 132) == 7
    assert tck.fwd_plan(512, 256, 132)[:2] == (4, 1)
    assert tck.fwd_plan(1024, 256, 132)[:2] == (1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        tck.fwd_plan(1280, 256, 132)
    x = torch.zeros(1, 3, 4, 4)
    wp2 = torch.zeros(128, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="band_rows"):
        tck.fused_phase_conv0_fwd(x, wp2, torch.zeros(128),
                                  plan._replace(band_rows=0))

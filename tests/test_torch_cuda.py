"""The port's CUDA kernels on the card: their wrappers' checks, their
launch counts, and every variant against its plain version at small
shapes (the preprocess kernel, and the fused phase-conv0 forward and dW
kernels, each at every plan the rig times).

Needs an NVIDIA GPU (marker ``cuda``); skips elsewhere. This file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import pytest
import torch

from skin_image_analysis_tpu_torch.ops.kernels import convblock_kernel as ck
from skin_image_analysis_tpu_torch.ops.kernels import preprocess_kernel as pk
from skin_image_analysis_tpu_torch.tools.perf_attrib import device_kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(dev, b=5, n=9, s=40, t=32, tail=True, seed=0, ch=3):
    g = torch.Generator(device=dev).manual_seed(seed)
    arena = torch.randint(0, 256, (n, ch, s, s), dtype=torch.uint8,
                          device=dev, generator=g)
    rows = torch.randint(0, n, (b,), dtype=torch.int32, device=dev,
                         generator=g)
    offsets = torch.randint(0, s - t + 1, (b, 2), dtype=torch.int32,
                            device=dev, generator=g)
    flips = torch.tensor([0, 1] * (b // 2) + [1] * (b % 2),
                         dtype=torch.int32, device=dev)
    scale = 0.9 / 255 + 0.2 / 255 * torch.rand(b, ch, device=dev,
                                                 generator=g)
    bias = (torch.zeros(b, ch, device=dev) if tail
            else torch.rand(b, ch, device=dev, generator=g) - 0.5)
    extra = ((0.8 + 0.4 * torch.rand(b, device=dev, generator=g),
              0.8 + 0.4 * torch.rand(b, device=dev, generator=g),
              1 + torch.rand(b, 3, device=dev, generator=g),
              torch.rand(b, 3, device=dev, generator=g) - 0.5)
             if tail else (None,) * 4)
    return (arena, offsets, flips, scale, bias, rows, *extra)


def _check_against_twin(args, t, out_dtype, s2d):
    """One launch, held to the plain version: float32 within 1e-6 (no
    tail) or 1e-5 (tail), bf16 within one ulp (at least 1e-5)."""
    kw = dict(image_size=t, out_dtype=out_dtype, space_to_depth=s2d)
    before = pk.fused_preprocess_planar.launches
    got = pk.fused_preprocess_planar(*args, **kw)
    torch.cuda.synchronize()
    assert pk.fused_preprocess_planar.launches == before + 1
    want = pk.fused_preprocess_planar_ref(*args, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous()
    err = (got.float() - want.float()).abs()
    if out_dtype == torch.float32:
        assert err.max() <= (1e-5 if args[6] is not None else 1e-6)
    else:
        _, e = torch.frexp(want.float())
        assert (err <= torch.clamp_min(torch.exp2((e - 8).float()),
                                       1e-5)).all()


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s2d", [False, True])
def test_kernel_matches_twin(dev, tail, out_dtype, s2d):
    _check_against_twin(_args(dev, tail=tail), 32, out_dtype, s2d)


# name: (_args keywords, crop); each runs planar f32, planar bf16 and, for
# an even crop, s2d bf16
EDGE_CASES = {
    # x0 = 0..15, each once unflipped and once flipped (set in the test)
    "x0_residues": (dict(b=32, s=64, t=32), 32),
    "t224_from_s256": (dict(b=3, n=4, s=256, t=224), 224),
    "t50_not_multiple_of_8": (dict(b=4, s=64, t=50), 50),
    "odd_t": (dict(b=4, s=40, t=31), 31),
    "one_channel_no_tail": (dict(ch=1, tail=False), 32),
    "s250_not_multiple_of_16": (dict(b=3, n=4, s=250, t=224), 224),
    "batch_of_one": (dict(b=1), 32),
    # tailed crops too large for one cluster: the sums launch
    "t770_sums_launch": (dict(b=2, n=3, s=784, t=770), 770),
    "t1024_sums_launch": (dict(b=3, n=3, s=1040, t=1024), 1024),
    "t1024_s1030_not_multiple_of_16": (dict(b=2, n=3, s=1030, t=1024), 1024),
}
EDGE_RUNS = [(name, dtype, s2d) for name, (_, t) in EDGE_CASES.items()
             for dtype, s2d in ((torch.float32, False),
                                (torch.bfloat16, False),
                                (torch.bfloat16, True)) if not (s2d and t % 2)]


@pytest.mark.parametrize("name,out_dtype,s2d", EDGE_RUNS)
def test_kernel_edges_match_twin(dev, name, out_dtype, s2d):
    kw, t = EDGE_CASES[name]
    args = list(_args(dev, seed=3, **kw))
    if name == "x0_residues":
        b = kw["b"]
        args[1][:, 1] = torch.arange(b, device=dev) // 2
        args[2] = (torch.arange(b, device=dev) % 2).to(torch.int32)
    _check_against_twin(args, t, out_dtype, s2d)


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("s2d", [False, True])
def test_one_device_kernel_per_call(dev, tail, s2d):
    args = _args(dev, tail=tail)
    kernels = device_kernels(lambda: pk.fused_preprocess_planar(
        *args, image_size=32, space_to_depth=s2d))
    assert sum(ev.count for ev in kernels) == 1
    assert "preprocess" in kernels[0].key


def test_oversize_crop_takes_two_device_kernels(dev):
    """A tailed 1024 crop: the sums launch, then the band launch."""
    args = _args(dev, b=2, n=3, s=1040, t=1024)
    assert pk.band_plan(1024, 3, tail=True).sums_launch
    before = pk.fused_preprocess_planar.launches
    kernels = device_kernels(
        lambda: pk.fused_preprocess_planar(*args, image_size=1024))
    assert pk.fused_preprocess_planar.launches == before + 3
    assert sum(ev.count for ev in kernels) == 2
    assert {"sums" in ev.key for ev in kernels} == {True, False}


def test_oversize_sums_beyond_32_bits_match_twin(dev):
    """A bright 4200 crop: each channel's sum passes 2^32 (4200^2 * 250),
    so the band kernel must add its bands' partials in 64 bits."""
    args = list(_args(dev, b=1, n=1, s=4200, t=4200))
    args[0] = torch.randint(250, 256, args[0].shape, dtype=torch.uint8,
                            device=dev)
    assert int(args[0][0, 0].sum(dtype=torch.int64)) >= 2 ** 32
    assert pk.band_plan(4200, 3, tail=True).sums_launch
    _check_against_twin(args, 4200, torch.float32, False)


def test_oversize_rows_outside_the_arena_give_nan(dev):
    args = list(_args(dev, b=3, n=3, s=1040, t=1024))
    args[5] = torch.tensor([0, 5, 2], dtype=torch.int32, device=dev)
    out = pk.fused_preprocess_planar(*args, image_size=1024)
    torch.cuda.synchronize()
    assert torch.isnan(out).flatten(1).all(1).tolist() == [False, True,
                                                           False]
    assert torch.isfinite(out[[0, 2]]).all()


@pytest.mark.parametrize("tail", [False, True])
def test_rows_outside_the_arena_give_nan(dev, tail):
    """Every block of a bad image's cluster stores NaN; the others are
    whole numbers."""
    args = list(_args(dev, tail=tail))
    args[5] = torch.tensor([0, 9, -1, 2, 3], dtype=torch.int32, device=dev)
    out = pk.fused_preprocess_planar(*args, image_size=32)
    torch.cuda.synchronize()
    bad = torch.isnan(out).flatten(1).all(1).tolist()
    assert bad == [False, True, True, False, False]
    assert torch.isfinite(out[[0, 3, 4]]).all()


@pytest.mark.parametrize("field,value,match", [
    (0, lambda a: a.float(), "uint8"),
    (1, lambda o: o.long(), "offsets"),
    (3, lambda s: s[:, :2].contiguous(), "scale"),
    (4, lambda b: b.t().contiguous().t(), "contiguous"),
    (5, lambda r: r.cpu(), "rows"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(dev, field, value,
                                                         match):
    args = list(_args(dev, tail=False))
    args[field] = value(args[field])
    before = pk.fused_preprocess_planar.launches
    with pytest.raises(ValueError, match=match):
        pk.fused_preprocess_planar(*args, image_size=32)
    assert pk.fused_preprocess_planar.launches == before


def test_wrapper_raises_on_unsupported_options(dev):
    args = _args(dev, tail=False)
    with pytest.raises(ValueError, match="even crop"):
        pk.fused_preprocess_planar(*args, image_size=31, space_to_depth=True)
    with pytest.raises(ValueError, match="out_dtype"):
        pk.fused_preprocess_planar(*args, image_size=32,
                                   out_dtype=torch.float16)
    with pytest.raises(ValueError, match="image_size"):
        pk.fused_preprocess_planar(*args, image_size=48)


# (B, 3, H, W): one band, the chunk-fallback size of the JAX tests, an odd
# pooled width with a partial last band, and several bands of a wide image
CONV_SHAPES = [(2, 3, 16, 16), (1, 3, 24, 24), (3, 3, 36, 18),
               (2, 3, 66, 40)]


def _conv_args(dev, shape, x_dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, device=dev, generator=g).to(x_dtype)
    w = 0.2 * torch.randn(32, 3, 7, 7, device=dev, generator=g)
    bias = 0.05 * torch.randn(32, device=dev, generator=g)
    return x, ck._pack_w(w), bias.repeat(4)


@pytest.fixture
def no_tf32():
    """Plain versions in full float32 (cuDNN convolutions and matmuls)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _check_fwd(args, plan=None):
    """One forward launch against the plain version: pooled within one
    bf16 ulp (at least 1e-5); selectors equal except where the plain
    version's top two phases, or its max and 0, are within 1e-4."""
    x = args[0]
    before = ck.fused_phase_conv0_fwd.launches
    pooled, sel = ck.fused_phase_conv0_fwd(*args, plan=plan)
    torch.cuda.synchronize()
    assert ck.fused_phase_conv0_fwd.launches == before + 1
    want, want_sel = ck.fused_phase_conv0_ref(*args)
    assert pooled.shape == want.shape and pooled.dtype == torch.bfloat16
    assert sel.shape == want_sel.shape and sel.dtype == torch.uint8
    err = (pooled.float() - want.float()).abs()
    _, e = torch.frexp(want.float())
    assert (err <= torch.clamp_min(torch.exp2((e - 8).float()), 1e-5)).all()
    y4 = ck.packed_conv0_y4(*args)
    top = y4.view(x.shape[0], 4, 32, *y4.shape[2:]).topk(2, dim=1).values
    near = ((top[:, 0] - top[:, 1]) <= 1e-4) | (top[:, 0].abs() <= 1e-4)
    assert near[sel != want_sel].all()
    return pooled, sel


# the forward kernel's edges beyond CONV_SHAPES: W/2 odd, H/2 not a
# multiple of the plan's band rows, the rig's 224 x 224, fewer tiles than
# SMs (one tile) and many more (B = 96 at 128 x 128: 384 tiles of 16
# pooled rows, about three a block)
FWD_SHAPES = CONV_SHAPES + [(1, 3, 20, 30), (2, 3, 42, 32), (2, 3, 224, 224),
                            (1, 3, 16, 16), (96, 3, 128, 128)]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_conv0_forward_matches_plain(dev, no_tf32, shape, x_dtype):
    """Held to :func:`_check_fwd`'s rule at the default plan."""
    _check_fwd(_conv_args(dev, shape, x_dtype))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_conv0_forward_at_an_unaligned_x_matches_plain(dev, no_tf32,
                                                       x_dtype):
    """A contiguous x whose data pointer is not 16-byte aligned (a view at
    element offset 1 of a larger buffer) takes the element path."""
    x, wp2, bias4 = _conv_args(dev, (2, 3, 32, 40), x_dtype)
    buf = torch.empty(x.numel() + 1, dtype=x_dtype, device=dev)
    xv = buf[1:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16
    _check_fwd((xv, wp2, bias4))


# every band size the rig's fwdplans times, at the one block an SM the
# kernel's registers allow, and a grid of twice the SMs (blocks that wait
# for an SM), at 224 and at a ragged width
FWD_PLANS = [(4, 1), (8, 1), (16, 1), (16, 2)]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,blocks", FWD_PLANS)
@pytest.mark.parametrize("shape", [(2, 3, 66, 40), (2, 3, 224, 224)])
def test_conv0_forward_plans_match_plain(dev, no_tf32, shape, rows, blocks,
                                         x_dtype):
    plan = ck.fwd_plan(shape[3], shape[0], 132)._replace(
        band_rows=rows, blocks_per_sm=blocks,
        smem_bytes=ck.fwd_smem_bytes(rows, shape[3]))
    _check_fwd(_conv_args(dev, shape, x_dtype, seed=6), plan)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_conv0_forward_twice_is_bit_identical(dev, x_dtype):
    args = _conv_args(dev, (4, 3, 224, 224), x_dtype, seed=7)
    a = ck.fused_phase_conv0_fwd(*args)
    b = ck.fused_phase_conv0_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_conv0_forward_kernel_spills_nothing_and_holds_its_plan(dev, x_dtype):
    """The build's registers leave no local (spill) memory, and an SM holds
    the plan's blocks of two warpgroups at 224."""
    info = ck.fwd_kernel_info(224, 256, x_dtype)
    assert info["local_bytes"] == 0
    assert info["blocks_per_sm"] >= info["plan_blocks_per_sm"] >= 1
    assert info["threads"] == 256 and info["warps_per_sm"] >= 8


@pytest.mark.parametrize("w", [2, 30, 40, 224, 512, 1024])
def test_fwd_plan_shared_memory_is_the_kernels(dev, w):
    """The plan's shared-memory bytes (computed on the host, so that the
    CPU tests can hold the plan) are those the kernel's launch takes."""
    assert (ck.fwd_kernel_info(w)["smem_bytes"]
            == ck.fwd_plan(w, 256, 132).smem_bytes)


# the dW kernel's edges beyond CONV_SHAPES: H/2 not a multiple of 4 * the
# cluster, W/2 odd with B = 1, and the rig's 224 x 224 at B = 2
DW_SHAPES = CONV_SHAPES + [(2, 3, 34, 32), (1, 3, 20, 30), (2, 3, 224, 224)]


def _dw_args(dev, shape, seed=1):
    x, wp2, bias4 = _conv_args(dev, shape, torch.bfloat16, seed=seed)
    _, sel = ck.fused_phase_conv0_ref(x, wp2, bias4)
    g = torch.randn(sel.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(seed))
    return x, g.to(torch.bfloat16), sel


@pytest.mark.parametrize("shape", DW_SHAPES)
def test_conv0_dw_matches_plain(dev, no_tf32, shape):
    """Per-image partials within 1e-3 of the plain version's largest
    magnitude (float32 sums in another order)."""
    x, g, sel = _dw_args(dev, shape)
    before = ck.fused_phase_conv0_dw.launches
    got = ck.fused_phase_conv0_dw(x, g, sel)
    torch.cuda.synchronize()
    assert ck.fused_phase_conv0_dw.launches == before + 1
    want = ck.fused_phase_conv0_dw_ref(x, g, sel)
    assert got.shape == want.shape == (shape[0], 128, 192)
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.parametrize("cluster", [1, 2, 8])
@pytest.mark.parametrize("shape", [(2, 3, 66, 40), (1, 3, 24, 24)])
def test_conv0_dw_cluster_sizes_match_plain(dev, no_tf32, shape, cluster):
    """Every cluster size the kernel takes, passed as the plan, including
    more blocks than bands (empty shares)."""
    x, g, sel = _dw_args(dev, shape, seed=4)
    plan = ck.dw_plan(shape[3], shape[0], 132)._replace(cluster=cluster)
    got = ck.fused_phase_conv0_dw(x, g, sel, plan)
    want = ck.fused_phase_conv0_dw_ref(x, g, sel)
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.parametrize("shape", [(2, 3, 66, 40), (2, 3, 224, 224)])
def test_conv0_dw_twice_is_bit_identical(dev, shape):
    """No atomics: the blocks' partials are summed in rank order."""
    x, g, sel = _dw_args(dev, shape, seed=5)
    a = ck.fused_phase_conv0_dw(x, g, sel)
    b = ck.fused_phase_conv0_dw(x, g, sel)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_conv0_dw_kernel_spills_nothing_and_fills_an_sm(dev):
    """The build's registers leave no local (spill) memory, and an SM holds
    at least 16 warps of the kernel at 224."""
    info = ck.dw_kernel_info(224, 256)
    assert info["local_bytes"] == 0
    assert info["warps_per_sm"] >= 16


@pytest.mark.parametrize("w", [2, 30, 40, 224, 1024, 1280])
def test_dw_plan_shared_memory_is_the_kernels(dev, w):
    """The plan's shared-memory bytes (computed on the host, so that the
    CPU tests can hold the plan) are those the kernel's launch takes."""
    assert (ck.dw_kernel_info(w)["smem_bytes"]
            == ck.dw_plan(w, 256, 132).smem_bytes)


def test_conv0_autograd_on_the_card_matches_the_cpu(dev, no_tf32):
    """The autograd Function on the card (both kernels) against itself on
    the CPU (the plain versions): output, dx, dW and db."""
    shape = (2, 3, 20, 28)
    x, _, _ = _conv_args(dev, shape, torch.float32, seed=2)
    w = 0.2 * torch.randn(32, 3, 7, 7, device=dev)
    bias = 0.05 * torch.randn(32, device=dev)
    g = torch.randn(shape[0], 32, 10, 14, device=dev).to(torch.bfloat16)
    outs = []
    for d in (dev, torch.device("cpu")):
        xt, wt, bt = (t.detach().to(d).requires_grad_(True)
                      for t in (x, w, bias))
        y = ck.fused_phase_conv0(xt, wt, bt)
        y.backward(g.to(d))
        outs.append([t.detach().float().cpu()
                     for t in (y, xt.grad, wt.grad, bt.grad)])
    for got, want in zip(*outs):
        assert (got - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.parametrize("what,match", [
    ("odd", "even"),
    ("dtype", "x must be one of"),
    ("wdtype", "wp2 must be one of"),
    ("strided", "contiguous"),
    ("cpu_weight", "wp2 is on"),
])
def test_conv0_forward_raises_on_what_the_kernel_does_not_take(dev, what,
                                                               match):
    x, wp2, bias4 = _conv_args(dev, (2, 3, 16, 16), torch.float32)
    if what == "odd":
        x = x[:, :, :15].contiguous()
    elif what == "dtype":
        x = x.half()
    elif what == "wdtype":
        wp2 = wp2.float()
    elif what == "strided":
        x = x.transpose(2, 3)
    else:
        wp2 = wp2.cpu()
    before = ck.fused_phase_conv0_fwd.launches
    with pytest.raises(ValueError, match=match):
        ck.fused_phase_conv0_fwd(x, wp2, bias4)
    assert ck.fused_phase_conv0_fwd.launches == before


@pytest.mark.parametrize("what,match", [
    ("odd", "even"),
    ("xdtype", "xb must be one of"),
    ("gdtype", "g must be one of"),
    ("strided", "contiguous"),
    ("selshape", "sel must have shape"),
])
def test_conv0_dw_raises_on_what_the_kernel_does_not_take(dev, what, match):
    x = torch.zeros(2, 3, 16, 16, dtype=torch.bfloat16, device=dev)
    g = torch.zeros(2, 32, 8, 8, dtype=torch.bfloat16, device=dev)
    sel = torch.zeros(2, 32, 8, 8, dtype=torch.uint8, device=dev)
    if what == "odd":
        x = x[:, :, :, :15].contiguous()
    elif what == "xdtype":
        x = x.float()
    elif what == "gdtype":
        g = g.float()
    elif what == "strided":
        g = g.transpose(2, 3)
    else:
        sel = sel[:, :, :4].contiguous()
    before = ck.fused_phase_conv0_dw.launches
    with pytest.raises(ValueError, match=match):
        ck.fused_phase_conv0_dw(x, g, sel)
    assert ck.fused_phase_conv0_dw.launches == before


def test_transfer_train_preprocess_matches_plain(dev):
    """The transfer trainer's augmented train call: crop 256 -> 224 and
    flip of B=32 rows of an arena, the ImageNet affine, float32 out, no
    tail; one launch, within 1e-6 of the same call on CPU tensors (the
    kernel's plain twin) on the same draws."""
    from skin_image_analysis_tpu_torch.ops import preprocess as pre

    g = torch.Generator(device=dev).manual_seed(3)
    arena = torch.randint(0, 256, (64, 3, 256, 256), dtype=torch.uint8,
                          device=dev, generator=g)
    rows = torch.randint(0, 64, (32,), dtype=torch.int32, device=dev,
                         generator=g)
    augment = pre.AugmentConfig(random_crop=True, horizontal_flip=True)
    draws = pre.draw_augment(32, 256, 224, augment, g)
    assert 0 < int(draws.flips.sum()) < 32
    kw = dict(image_size=224, train=True, augment=augment,
              normalize_imagenet=True)
    before = pk.fused_preprocess_planar.launches
    got = pre.preprocess_planar_batch(arena, rows=rows, draws=draws, **kw)
    torch.cuda.synchronize()
    assert pk.fused_preprocess_planar.launches == before + 1
    want = pre.preprocess_planar_batch(
        arena.cpu(), rows=rows.cpu(),
        draws=pre.AugmentDraws(draws.offsets.cpu(), draws.flips.cpu(),
                               None, None, None), **kw)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (32, 224, 224, 3)
    assert float((got.cpu() - want).abs().max()) <= 1e-6
    fn = pre.make_preprocess_fn(224, train=True, augment=augment,
                                normalize_imagenet=True, layout="planar")
    out = fn(arena, g, rows=rows)
    assert out.shape == (32, 224, 224, 3)
    assert pk.fused_preprocess_planar.launches == before + 2


def test_resnet_batchnorm_on_the_card_matches_cpu(dev, no_tf32):
    """resnet18 (the init's zero scale on each block's last BatchNorm) in
    float32: a train-mode forward (batch statistics), the running
    statistics it moves and the eval forward on the card within 1e-5 of
    the same on the CPU; the BatchNorm alone likewise."""
    from skin_image_analysis_tpu_torch.config import ModelConfig
    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.models.resnet import BatchNorm

    x = torch.randn(8, 64, 16, 16, generator=torch.Generator().manual_seed(0))
    bns = []
    for d in ("cpu", dev):
        bn = BatchNorm(64, "float32", device=d)
        bn.reset_parameters(None)
        with torch.no_grad():
            bns.append((bn(x.to(d), train=True).cpu(), bn.running_var.cpu(),
                        bn(x.to(d), train=False).cpu()))
    errs = [float((a - b).abs().max()) for a, b in zip(*bns)]
    assert max(errs) <= 1e-5, errs

    cfg = ModelConfig(name="resnet18", image_size=64,
                      compute_dtype="float32")
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    cpu.head_dropout = card.head_dropout = 0.0  # no draws to tell apart
    x = torch.randn(8, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        train_cpu = cpu(x, train=True)
        train_card = card(x.to(dev), train=True).cpu()
        eval_cpu, eval_card = cpu(x), card(x.to(dev)).cpu()
    errs = {"train": float((train_card - train_cpu).abs().max()),
            "eval": float((eval_card - eval_cpu).abs().max())}
    for (k, a), b in zip(cpu.state_dict().items(),
                         card.state_dict().values()):
        if "running" in k:
            errs[k] = float((a - b.cpu()).abs().max())
    assert max(errs.values()) <= 1e-5, errs


# -- the fused BatchNorm ------------------------------------------------------

#: (C, H*W) of ResNet-50's BatchNorms at 224² (each once), and odd shapes:
#: H*W of 49 and 9, C not a multiple of 8, N=1
BN_RESNET50 = [(64, 12544), (64, 3136), (256, 3136), (128, 3136),
               (128, 784), (512, 784), (256, 784), (256, 196), (1024, 196),
               (512, 196), (512, 49), (2048, 49)]
BN_ODD = [(1, 3, 9), (3, 13, 49), (1, 2048, 49), (2, 5, 9), (1, 64, 12544),
          (5, 24, 196)]
BN_CASES = [(256, c, hw) for c, hw in BN_RESNET50] + BN_ODD
BN_EPILOGUES = [(False, False), (True, False), (True, True)]


def _bn_inputs(dev, n, c, hw, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    side = int(round(hw ** 0.5))
    shape = (n, c, side, hw // side)
    x = (torch.randn(shape, device=dev, generator=g) * 1.5 + 0.3).to(dtype)
    if c > 1:
        x[:, 1] = 3.3  # a constant channel: its variance clamps or is 0
    p = dict(
        weight=torch.rand(c, device=dev, generator=g) + 0.5,
        bias=torch.randn(c, device=dev, generator=g) * 0.2,
        running_mean=torch.randn(c, device=dev, generator=g) * 0.1,
        running_var=torch.rand(c, device=dev, generator=g) + 0.5)
    residual = torch.randn(shape, device=dev, generator=g).to(dtype)
    dy = torch.randn(shape, device=dev, generator=g).to(dtype)
    return x, p, residual, dy


def _bn_close_sums(got, want, terms, what):
    """Per-channel float32 sums taken in another order: within 2e-5 of the
    sum of the terms' magnitudes (and 1e-6)."""
    err = (got - want).abs()
    bound = 2e-5 * terms + 1e-6
    assert bool((err <= bound).all()), (what, float((err - bound).max()))


@pytest.mark.parametrize("shape", BN_CASES,
                         ids=[f"{n}x{c}x{hw}" for n, c, hw in BN_CASES])
def test_batchnorm_kernel_against_plain(dev, shape):
    """Train forward, backward and eval forward against the plain versions
    on the card, bf16, each epilogue in turn: the statistics and running
    averages to float32 round-off (their sums run in another order), y
    bit for bit given the kernel's statistics, the eval form bit for bit,
    dx within one bf16 ulp (and 1e-4 of its largest), the residual's
    gradient bit for bit, dgamma and dbeta to round-off."""
    n, c, hw = shape
    _bn_check(dev, shape, *BN_EPILOGUES[(c + hw + n) % 3], eps=1e-5)


#: (C, H*W) of Xception's BatchNorms at 299² (B=256): the planes of 147²,
#: 74², 37², 19² and 10², each odd or unaligned to 16 bytes in bf16
BN_XCEPTION = [(64, 147 * 147), (128, 147 * 147), (728, 37 * 37),
               (728, 19 * 19), (1536, 10 * 10)]


@pytest.mark.parametrize("c,hw", BN_XCEPTION,
                         ids=[f"256x{c}x{hw}" for c, hw in BN_XCEPTION])
def test_batchnorm_kernel_at_xception_shapes(dev, c, hw):
    """The same checks at Xception's shapes, with Keras's epsilon 1e-3 and
    no epilogue (Xception's ReLUs are separate operations)."""
    _bn_check(dev, (256, c, hw), False, False, eps=1e-3)


def _bn_check(dev, shape, relu: bool, res: bool, eps: float) -> None:
    """The kernels against the plain versions at ``shape``, with the
    epilogue ``relu`` / ``res`` and epsilon ``eps``."""
    from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel \
        as bk

    n, c, hw = shape
    x, p, residual, dy = _bn_inputs(dev, n, c, hw)
    r = residual if res else None
    rm, rv = p["running_mean"].clone(), p["running_var"].clone()
    rm2, rv2 = rm.clone(), rv.clone()
    before = bk.batchnorm_train_forward.launches
    y, mean, rstd, varg = bk.batchnorm_train_forward(
        x, p["weight"], p["bias"], rm, rv, momentum=0.99, eps=eps,
        relu=relu, residual=r)
    torch.cuda.synchronize()
    assert bk.batchnorm_train_forward.launches == before + 1
    _, mean_p, rstd_p, raw_p = bk.batchnorm_ref(
        x, p["weight"], p["bias"], rm2, rv2, train=True, momentum=0.99,
        eps=eps)
    xf = x.float()
    _bn_close_sums(mean, mean_p, xf.abs().mean(dim=(0, 2, 3)), "mean")
    # not a (near-)constant channel, whose variance is the round-off of
    # E[x^2] - E[x]^2 (at epsilon 1e-5 the same channels as rstd < 100)
    live = raw_p > 9e-5
    torch.testing.assert_close(rstd[live], rstd_p[live], rtol=2e-5, atol=0)
    assert bool((varg[live] == 1).all())
    torch.testing.assert_close(rm, rm2, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(rv[live], rv2[live], rtol=2e-5, atol=1e-7)
    assert torch.equal(y, bk.batchnorm_apply_ref(
        xf, p["weight"], p["bias"], mean, rstd, x.dtype, relu, r))

    out = y if relu and res else None
    before = bk.batchnorm_backward.launches
    dx, dw, db, dres = bk.batchnorm_backward(
        dy, x, out, p["weight"], p["bias"], mean, rstd, varg, relu=relu,
        residual=res)
    torch.cuda.synchronize()
    assert bk.batchnorm_backward.launches == before + 1
    dx_p, dw_p, db_p, dres_p = bk.batchnorm_backward_ref(
        dy, x, y, p["weight"], mean, rstd, varg, relu=relu, residual=res)
    err = (dx.float() - dx_p.float()).abs()
    tol = dx_p.float().abs() * 2 ** -7 + 1e-4 * float(dx_p.abs().max())
    assert bool((err <= tol).all()), float((err - tol).max())
    g = torch.where(y <= 0, 0.0, dy.float()) if relu else dy.float()
    xhat = (xf - mean[:, None, None]) * rstd[:, None, None]
    _bn_close_sums(db, db_p, g.abs().sum(dim=(0, 2, 3)), "dbeta")
    _bn_close_sums(dw, dw_p, (g * xhat).abs().sum(dim=(0, 2, 3)), "dgamma")
    if res:
        assert torch.equal(dres, dres_p)
    else:
        assert dres is None

    before = bk.batchnorm_eval_forward.launches
    rs = torch.empty_like(rv)
    ye = bk.batchnorm_eval_forward(x, p["weight"], p["bias"], rm, rv,
                                   eps=eps, relu=relu, residual=r, rstd=rs)
    torch.cuda.synchronize()
    assert bk.batchnorm_eval_forward.launches == before + 1
    assert torch.equal(ye, bk.batchnorm_ref(
        x, p["weight"], p["bias"], rm, rv, train=False, momentum=0.99,
        eps=eps, relu=relu, residual=r)[0])
    assert torch.equal(rs, torch.rsqrt(rv + eps))
    out = ye if relu and res else None
    dx, dw, db, dres = bk.batchnorm_backward(
        dy, x, out, p["weight"], p["bias"], rm, rs, None, relu=relu,
        residual=res)
    dx_p, dw_p, db_p, dres_p = bk.batchnorm_backward_ref(
        dy, x, ye, p["weight"], rm, rs, None, relu=relu, residual=res)
    assert torch.equal(dx, dx_p)
    assert dres is None if not res else torch.equal(dres, dres_p)
    _bn_close_sums(db, db_p, dy.float().abs().sum(dim=(0, 2, 3)), "dbeta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_batchnorm_kernel_other_dtypes(dev, dtype):
    """float32 and float16 activations (a float32 model on the card, as
    the explain and migrate paths run one): the same checks in brief."""
    from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel \
        as bk

    for n, c, hw in ((8, 64, 196), (3, 13, 49)):
        x, p, residual, dy = _bn_inputs(dev, n, c, hw, dtype)
        rm, rv = p["running_mean"].clone(), p["running_var"].clone()
        y, mean, rstd, varg = bk.batchnorm_train_forward(
            x, p["weight"], p["bias"], rm, rv, momentum=0.99, eps=1e-5,
            relu=True, residual=residual)
        assert torch.equal(y, bk.batchnorm_apply_ref(
            x.float(), p["weight"], p["bias"], mean, rstd, dtype, True,
            residual))
        ye = bk.batchnorm_eval_forward(x, p["weight"], p["bias"], rm, rv,
                                       eps=1e-5, relu=True)
        assert torch.equal(ye, bk.batchnorm_ref(
            x, p["weight"], p["bias"], rm, rv, train=False, momentum=0.99,
            eps=1e-5, relu=True)[0])
        dx, *_ = bk.batchnorm_backward(dy, x, y, p["weight"], p["bias"],
                                       mean, rstd, varg, relu=True,
                                       residual=True)
        dx_p, *_ = bk.batchnorm_backward_ref(
            dy, x, y, p["weight"], mean, rstd, varg, relu=True,
            residual=True)
        ulp = 2 ** -23 if dtype == torch.float32 else 2 ** -10
        err = (dx.float() - dx_p.float()).abs()
        tol = dx_p.float().abs() * 2 * ulp + 1e-4 * float(dx_p.abs().max())
        assert bool((err <= tol).all())


def test_batchnorm_kernel_twice_bit_identical(dev):
    """No atomics: two train forwards and backwards give the same bits."""
    from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel \
        as bk

    x, p, residual, dy = _bn_inputs(dev, 256, 256, 3136)
    runs = []
    for _ in range(2):
        rm, rv = p["running_mean"].clone(), p["running_var"].clone()
        fwd = bk.batchnorm_train_forward(
            x, p["weight"], p["bias"], rm, rv, momentum=0.99, eps=1e-5,
            relu=True, residual=residual)
        bwd = bk.batchnorm_backward(dy, x, fwd[0], p["weight"], p["bias"],
                                    *fwd[1:], relu=True, residual=True)
        runs.append([*fwd, *bwd, rm, rv])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("what", ["dtype", "device", "strided", "aligned",
                                  "residual", "layout", "params",
                                  "epilogue"])
def test_batchnorm_kernel_refuses(dev, what):
    from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel \
        as bk

    x, p, residual, _ = _bn_inputs(dev, 2, 16, 49)
    kw = dict(momentum=0.99, eps=1e-5)
    if what == "dtype":
        x = x.double()
    elif what == "device":
        p["weight"] = p["weight"].cpu()
    elif what == "strided":
        x = x.transpose(2, 3)
    elif what == "aligned":
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        x = flat[1:].view(x.shape).copy_(x)
    elif what == "residual":
        kw.update(relu=True, residual=residual.float())
    elif what == "layout":
        x = x.contiguous(memory_format=torch.channels_last)
    elif what == "epilogue":
        kw["residual"] = residual
    else:
        p["bias"] = p["bias"][:8]
    before = bk.batchnorm_train_forward.launches
    with pytest.raises(ValueError):
        bk.batchnorm_train_forward(x, p["weight"], p["bias"],
                                   p["running_mean"], p["running_var"], **kw)
    assert bk.batchnorm_train_forward.launches == before


def _graph_kernels(fn) -> int:
    """The device kernels one call of ``fn`` launches, counted as the
    kernel nodes of a CUDA graph captured from it (captured, not run).
    The profiler is no count here: its sessions can drop the records of
    kernels launched from a library with a CUDA runtime of its own."""
    import ctypes

    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int()
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    g.reset()
    return kinds.count(0)  # CU_GRAPH_NODE_TYPE_KERNEL


def _resnet_step(model, x, y):
    model.zero_grad(set_to_none=True)
    loss = torch.nn.functional.nll_loss(model(x, train=True), y)
    loss.backward()
    return loss.detach(), {k: v.grad.clone() for k, v
                           in model.named_parameters()}


def test_resnet50_through_the_kernel(dev, monkeypatch):
    """A resnet50 bf16 train step (B=16, 64²) launches the train forward
    and the backward once per BatchNorm (53), three device kernels each,
    and the no-grad eval forward 53 eval launches; against the same step
    with the float32 chain on the card (``_fused`` off): the loss, the
    running averages and the eval log-probs within bf16 round-off of the
    network, the median leaf's gradient pointing the same way (a tiny
    batch under BatchNorm makes the worst leaf's chaotic). Its NHWC input
    leaves the stem's activation channels-last, which the first
    BatchNorm makes NCHW for the kernels."""
    from skin_image_analysis_tpu_torch.models import resnet
    from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel \
        as bk

    host = resnet.resnet50(num_classes=7)
    host.reset_parameters(torch.Generator().manual_seed(1))
    model = host.to(dev)
    model.head_dropout = 0.0
    chain = resnet.resnet50(num_classes=7, device=dev)
    chain.load_state_dict(model.state_dict())
    chain.head_dropout = 0.0
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand(16, 64, 64, 3, device=dev, generator=g)
    y = torch.randint(0, 7, (16,), device=dev, generator=g)
    counts = [bk.batchnorm_train_forward.launches,
              bk.batchnorm_backward.launches]
    loss, grads = _resnet_step(model, x, y)
    torch.cuda.synchronize()
    assert [bk.batchnorm_train_forward.launches - counts[0],
            bk.batchnorm_backward.launches - counts[1]] == [53, 53]
    before = bk.batchnorm_eval_forward.launches
    with torch.no_grad():
        ev = model(x)
    assert bk.batchnorm_eval_forward.launches - before == 53

    bn = model.blocks[3].bn2
    h = torch.randn(4, bn.weight.shape[0], 8, 8, device=dev).bfloat16()
    assert _graph_kernels(lambda: bn(h, True, relu=True, residual=h)) == 3

    with monkeypatch.context() as m:
        m.setattr(resnet, "_fused", lambda x, train: False)
        loss_c, grads_c = _resnet_step(chain, x, y)
        with torch.no_grad():
            ev_c = chain(x)
    assert abs(float(loss) - float(loss_c)) <= 2e-2 * abs(float(loss_c))
    assert float((ev - ev_c).abs().max()) <= 5e-2
    for (k, a), b in zip(model.state_dict().items(),
                         chain.state_dict().values()):
        if "running" in k:
            assert float((a - b).abs().max()) <= 1e-2 * max(
                float(b.abs().max()), 1.0), k
    cos = sorted(float(torch.nn.functional.cosine_similarity(
        grads[k].flatten().float(), grads_c[k].flatten().float(), dim=0))
        for k in grads if float(grads_c[k].abs().max()) > 0)
    assert cos[len(cos) // 2] > 0.99, cos


def test_export_on_the_card_keeps_the_chain(dev):
    """``serve.export``'s program exported on the card: the graph is the
    chain's, node for node the graph exported on the CPU (where the
    kernels never run), and the artifact agrees with the eager program."""
    from skin_image_analysis_tpu_torch.config import ModelConfig
    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel \
        as bk
    from skin_image_analysis_tpu_torch.serve.export import build_infer_fn

    cfg = ModelConfig(name="resnet18", num_classes=2, image_size=32,
                      compute_dtype="bfloat16")
    state = build_model(cfg, device="cpu").state_dict()
    graphs = {}
    for d in ("cpu", dev):
        program = build_infer_fn(cfg, state, device=d)
        example = torch.zeros((2, 32, 32, 3), dtype=torch.uint8, device=d)
        before = (bk.batchnorm_eval_forward.launches,
                  bk.batchnorm_train_forward.launches)
        with torch.no_grad():
            ep = torch.export.export(program, (example,))
        assert (bk.batchnorm_eval_forward.launches,
                bk.batchnorm_train_forward.launches) == before
        graphs[str(d)] = [str(n.target) for n in ep.graph.nodes
                          if n.op == "call_function"]
        if d != "cpu":
            px = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                               device=d)
            with torch.no_grad():
                got = ep.module()(px)
                want = program(px)
            assert torch.equal(got["pred"], want["pred"])
    assert graphs["cpu"] == graphs[str(dev)]
    assert not any("sia" in t for t in graphs["cpu"])

"""The depthwise 3x3 kernels (``ops.kernels.depthwise_kernel``): on the
CPU their plain versions against the JAX package's ``feature_group_count``
conv, the launch plan and the dispatch of ``models.resnet.Conv``; on the
card (marker ``cuda``, skipped elsewhere) the kernels against the plain
versions at every Xception shape and at MobileNetV2's and EfficientNet-B0's
stride-1 3x3 shapes, bit-identical dW, the wrapper's refusals and the
models' convs through the kernels.

The module imports no JAX at its top (the JAX case imports it itself), so
the card's cases also run where JAX is absent: ``python -m pytest
--noconftest -m cuda tests/test_torch_depthwise_kernel.py``."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models import resnet
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.ops.kernels import depthwise_kernel as dk

#: Xception's depthwise convs at 299²: (channels, side) and convs of each
XCEPTION = {(64, 147): 1, (128, 147): 1, (128, 74): 1, (256, 74): 1,
            (256, 37): 1, (728, 37): 1, (728, 19): 26, (1024, 10): 1,
            (1536, 10): 1}
#: every plane side of Xception's, and channel counts from 64 to 2,048
SIDES = (147, 74, 37, 19, 10)
CHANNELS = (64, 728, 2048)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread: under the suite's workers the default
    pool slows the models' CPU forwards many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(shape, dtype=torch.float32, seed=0):
    """x, dy [N, C, H, W] and a float32 weight [C, 1, 3, 3] from numpy."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    weight = torch.from_numpy(
        rng.standard_normal((c, 1, 3, 3), dtype=np.float32) * 0.5)
    return x.to(dtype), dy.to(dtype), weight


# -- the plain versions on the CPU ------------------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 5, 7), (1, 4, 6, 6), (3, 2, 7, 4),
                                   (2, 5, 1, 9)],
                         ids=["5x7", "6x6", "7x4", "1x9"])
def test_plain_against_jax_feature_group_count(shape):
    """float32: the plain forward, dx and dW equal the JAX package's
    Xception depthwise layer (a Flax conv with ``feature_group_count``,
    SAME, its pointwise 1x1 set to the identity) and its VJP, on the same
    numpy inputs, to float32 round-off."""
    import jax
    import jax.numpy as jnp

    from skin_image_analysis_tpu.models.xception import SeparableConv

    x, dy, weight = _inputs(shape)
    c = shape[1]
    kernel = jnp.asarray(np.transpose(weight.numpy(), (2, 3, 1, 0)))
    eye = jnp.eye(c, dtype=jnp.float32)[None, None]
    layer = SeparableConv(features=c, compute_dtype="float32")

    def f(xn, k):
        return layer.apply({"params": {"depthwise": {"kernel": k},
                                       "pointwise": {"kernel": eye}}}, xn)

    xn = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    y, vjp = jax.vjp(f, xn, kernel)
    dxn, dk_ = vjp(jnp.asarray(dy.permute(0, 2, 3, 1).numpy()))
    want_y = torch.from_numpy(np.asarray(y)).permute(0, 3, 1, 2)
    want_dx = torch.from_numpy(np.asarray(dxn)).permute(0, 3, 1, 2)
    want_dw = torch.from_numpy(np.transpose(np.asarray(dk_), (3, 2, 0, 1)))

    got_y = dk.depthwise3x3_ref(x, weight)
    got_dx, got_dw = dk.depthwise3x3_backward_ref(dy, x, weight)
    assert got_y.dtype == got_dx.dtype == got_dw.dtype == torch.float32
    assert got_dw.shape == weight.shape
    for got, want in ((got_y, want_y), (got_dx, want_dx),
                      (got_dw, want_dw)):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_plain_rounds_the_weight_and_the_output_once(dtype):
    """At a 16-bit type the plain forward is the float64 correlation of x
    with the weight rounded to x's type, rounded once (within float32's
    round-off before that rounding); dx likewise; dW stays float32."""
    x, dy, weight = _inputs((2, 3, 6, 5), dtype)
    w = weight.to(dtype).double()
    y = dk.depthwise3x3_ref(x, weight)
    want = F.conv2d(x.double(), w, padding=1, groups=3)
    assert y.dtype == dtype
    assert torch.equal(y, want.to(dtype)) or float(
        (y.double() - want).abs().max()) <= float(
        want.abs().max()) * 2 ** -7
    dx, dw = dk.depthwise3x3_backward_ref(dy, x, weight)
    dx64, dw64 = dk.depthwise3x3_backward_ref(dy.double(), x.double(), w)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    assert float((dx.double() - dx64).abs().max()) <= float(
        dx64.abs().max()) * 2 ** -7
    assert torch.allclose(dw.double(), dw64, rtol=1e-5, atol=1e-5)


# -- the launch plan ---------------------------------------------------------


def _check_plan(n, c, h, w, elem_bytes, sources):
    plan = dk.depthwise_plan(n, c, h, w, elem_bytes, sources)
    vec = 16 // elem_bytes
    # every output row of every plane in exactly one unit of one block, as
    # the kernels walk them: block ``chunk`` of a channel takes units
    # [chunk, chunk + 1) * stages * group, unit u band u % bands of plane
    # u // bands, band b rows [b, b + 1) * rows
    covered = np.zeros((n, h), dtype=np.int64)
    per = plan.stages * plan.group
    for chunk in range(plan.chunks):
        units = range(chunk * per, min((chunk + 1) * per, n * plan.bands))
        assert len(units) > 0, "an empty block"
        for u in units:
            plane, band = divmod(u, plan.bands)
            rows = range(band * plan.rows, min((band + 1) * plan.rows, h))
            assert 0 < len(rows) <= plan.rows
            covered[plane, rows.start:rows.stop] += 1
    assert (covered == 1).all()
    # the slot holds a band with its halo rows and the reads' margins
    assert plan.slot % vec == 0
    assert plan.slot >= (plan.rows + 2) * w + 6 * vec
    assert plan.lmax * vec >= (plan.rows + 2) * w + 2 * (vec - 1)
    assert plan.kmax * vec >= plan.rows * w + 2 * (vec - 1)
    assert 1 <= plan.group <= dk.MAX_GROUP
    assert plan.group * plan.slot * elem_bytes <= max(
        dk.STAGE_BYTES[sources], plan.slot * elem_bytes)
    assert dk.shared_bytes(plan, elem_bytes, sources) <= dk.MAX_SHARED
    assert plan.chunks <= 65535
    return plan


@pytest.mark.parametrize("sources", [1, 2], ids=["forward", "backward"])
@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("batch", [1, 3, 256])
@pytest.mark.parametrize("side", SIDES)
def test_plan_covers_every_row_once(side, batch, elem_bytes, sources):
    """At Xception's plane sides, C from 64 to 2,048 and B from 1 to 256:
    every output row of every plane lies in exactly one band of one block,
    the slots hold a band with its halo, and the shared memory fits."""
    for c in CHANNELS:
        _check_plan(batch, c, side, side, elem_bytes, sources)


@pytest.mark.parametrize("sources", [1, 2], ids=["forward", "backward"])
def test_plan_at_xception(sources):
    """Xception's convs at B=256, bf16: at least TARGET_BLOCKS blocks, each
    walking at least MIN_STAGES stages; planes of 37² and less share a
    stage, 147² planes are cut into bands."""
    for (c, side), _ in XCEPTION.items():
        plan = _check_plan(256, c, side, side, 2, sources)
        assert c * plan.chunks >= dk.TARGET_BLOCKS
        assert plan.stages >= dk.MIN_STAGES
        if side <= 37:
            assert plan.rows == side and plan.group > 1
        if side == 147:
            assert plan.bands > 1 and plan.group == 1


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 1, 9), (5, 2, 9, 1),
                                   (3, 7, 2, 2), (1, 4, 300, 40),
                                   (2, 1, 13, 2000)],
                         ids=["1x1", "1x9", "9x1", "2x2", "300x40",
                              "13x2000"])
def test_plan_odd_shapes(shape):
    for elem_bytes in (2, 4):
        for sources in (1, 2):
            _check_plan(*shape, elem_bytes, sources)


def test_plan_stage_sizes():
    """The forward stages more than the backward (one tensor, not two):
    Xception's 147² planes in 2 bands forward and 3 backward, 27 and 16
    of its 19² planes a stage."""
    fwd = dk.depthwise_plan(256, 64, 147, 147, 2, 1)
    bwd = dk.depthwise_plan(256, 64, 147, 147, 2, 2)
    assert (fwd.bands, bwd.bands) == (2, 3)
    assert dk.depthwise_plan(256, 728, 19, 19, 2, 1).group == 27
    assert dk.depthwise_plan(256, 728, 19, 19, 2, 2).group == 16
    assert dk.stage_cost(1) == dk.stage_cost(256) == 2
    assert dk.stage_cost(257) == 3
    with pytest.raises(ValueError):
        dk.depthwise_plan(1, 1, 0, 3)
    with pytest.raises(ValueError):
        dk.depthwise_plan(1, 1, 3, 3, 2, 3)


def test_bytes_of_xception():
    """Xception's 34 convs move 29.38 M activation elements an image
    forward (x read, y written), 15.04 GB at B=256 in bf16; the backward
    1.5 times that (x and dy read, dx written)."""
    fwd = sum(k * dk.depthwise_bytes(256, c, s, s)
              for (c, s), k in XCEPTION.items())
    bwd = sum(k * dk.depthwise_bytes(256, c, s, s, form="backward")
              for (c, s), k in XCEPTION.items())
    assert sum(XCEPTION.values()) == 34
    assert fwd == 2 * 256 * 2 * sum(k * c * s * s for (c, s), k
                                     in XCEPTION.items())
    assert round(fwd / 2 / 256 / 2 / 1e6, 2) == 14.69
    assert round(fwd / 1e9, 2) == 15.04 and 2 * bwd == 3 * fwd
    with pytest.raises(ValueError):
        dk.depthwise_bytes(1, 1, 1, 1, form="dw")


# -- dispatch ----------------------------------------------------------------

CUDA = torch.device("cuda")


def _like(c, dtype=torch.float32, device=CUDA):
    """A stand-in for an NCHW activation on the card."""
    return types.SimpleNamespace(device=device, shape=(2, c, 8, 8),
                                 dtype=dtype)


def test_dispatch_rules(monkeypatch):
    """A depthwise 3x3 conv at stride 1 with a zero padding of 1 and no
    bias takes the kernels on the card; stride 2, 5x5, grouped convs that
    are not depthwise, a bias, another dtype, the CPU and a trace do
    not."""
    def conv(cin, cout, k, s, p, groups, bias=False):
        return resnet.Conv(cin, cout, k, s, p, "float32", "meta",
                           groups=groups, bias=bias)

    dw = conv(8, 8, 3, 1, 1, 8)
    assert dw.depthwise3x3(_like(8), 1)
    assert dw.depthwise3x3(_like(8), (1, 1))
    assert not dw.depthwise3x3(_like(8), 0)
    assert not dw.depthwise3x3(_like(8), (0, 1))
    assert not dw.depthwise3x3(_like(8, torch.bfloat16), 1)
    assert not dw.depthwise3x3(_like(8, device=torch.device("cpu")), 1)
    assert not conv(8, 8, 3, 2, 1, 8).depthwise3x3(_like(8), 1)
    assert not conv(8, 8, 5, 1, 2, 8).depthwise3x3(_like(8), 1)
    assert not conv(8, 8, 3, 1, 1, 4).depthwise3x3(_like(8), 1)
    assert not conv(8, 16, 3, 1, 1, 8).depthwise3x3(_like(8), 1)
    assert not conv(8, 8, 3, 1, 1, 8, bias=True).depthwise3x3(_like(8), 1)
    assert not conv(8, 8, 3, 1, 1, 1).depthwise3x3(_like(8), 1)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    assert not dw.depthwise3x3(_like(8), 1)
    assert not resnet._fused(_like(8), False)


def _recorded(monkeypatch, model, x):
    """The model's forward of x on the CPU as if on the card: every conv
    the dispatch sends to the kernels runs the plain version instead and
    is recorded (the BatchNorms keep their CPU path). Returns (log-probs,
    [(conv, input shape)])."""
    calls = []
    convs = {id(m.weight): m for m in model.modules()
             if isinstance(m, resnet.Conv)}

    def kernel(xk, weight):
        calls.append((convs[id(weight)], tuple(xk.shape)))
        return dk.depthwise3x3_ref(xk, weight)

    monkeypatch.setattr(resnet, "_on_card", lambda t: True)
    monkeypatch.setattr(resnet, "_fused", lambda t, train: False)
    monkeypatch.setattr(dk, "depthwise3x3", kernel)
    with torch.no_grad():
        out = model(x)
    monkeypatch.undo()
    return out, calls


def _stride1_3x3(model):
    return [m for m in model.modules() if isinstance(m, resnet.Conv)
            and m.groups > 1 and m.groups == m.weight.shape[0]
            and m.weight.shape[-1] == 3 and m.stride == 1]


@pytest.mark.parametrize("name,side,taken", [
    ("xception", 71, 34), ("mobilenet_v2", 64, 13),
    ("efficientnet_b0", 64, 5)])
def test_models_send_their_stride1_3x3_depthwise_convs(monkeypatch, name,
                                                        side, taken):
    """Xception's 34 depthwise convs, MobileNetV2's 13 stride-1 ones (not
    its 4 stride-2) and EfficientNet-B0's 5 stride-1 3x3 ones (not its
    stride-2 nor its 5x5 ones) take the kernels; the forward equals the
    F.conv2d path's to float32 round-off (float32: the plain version is the
    same conv, of a contiguous input)."""
    model = build_model(ModelConfig(name=name, num_classes=3,
                                    image_size=side,
                                    compute_dtype="float32"), device="cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(1, side, side, 3,
                   generator=torch.Generator().manual_seed(1))
    out, calls = _recorded(monkeypatch, model, x)
    assert len(calls) == taken
    assert {id(m) for m, _ in calls} == {id(m) for m in _stride1_3x3(model)}
    assert all(m.weight.shape[1:] == (1, 3, 3) for m, _ in calls)
    with torch.no_grad():
        want = model(x)
    assert torch.allclose(out, want, rtol=1e-5, atol=1e-6)


def test_cpu_tensor_takes_conv2d(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernels' entry ran on a CPU tensor")

    monkeypatch.setattr(dk, "depthwise3x3", refuse)
    conv = resnet.Conv(4, 4, 3, 1, 1, "float32", groups=4)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(2, 4, 5, 5)
    assert torch.equal(conv(x), F.conv2d(x, conv.weight, padding=1,
                                         groups=4))


def test_export_trace_takes_conv2d(monkeypatch):
    """While ``torch.export`` traces, a conv the dispatch would send to
    the kernels takes F.conv2d, so the exported graph keeps its ATen
    depthwise conv."""
    monkeypatch.setattr(resnet, "_on_card", lambda t: (
        not torch.compiler.is_exporting()))

    def refuse(*a, **kw):
        raise AssertionError("the kernels' entry ran in a trace")

    monkeypatch.setattr(dk, "depthwise3x3", refuse)
    conv = resnet.Conv(4, 4, 3, 1, "same", "float32", groups=4)
    conv.reset_parameters(torch.Generator().manual_seed(0))
    program = torch.export.export(conv, (torch.rand(1, 4, 6, 6),))
    ops = [str(n.target) for n in program.graph.nodes]
    assert any("conv2d" in op or "convolution" in op for op in ops)


def test_function_wiring(monkeypatch):
    """The autograd Function around the kernels, with the plain versions
    standing in for them: the forward's output and both gradients equal
    F.conv2d's autograd in float64; an input that needs no gradient gets
    none."""
    monkeypatch.setattr(dk, "depthwise_forward", dk.depthwise3x3_ref)
    monkeypatch.setattr(dk, "depthwise_backward",
                        dk.depthwise3x3_backward_ref)
    x, dy, weight = _inputs((2, 3, 5, 4), torch.float64)
    weight = weight.double()
    xa, wa = x.clone().requires_grad_(), weight.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), weight.clone().requires_grad_()
    y = dk.depthwise3x3(xa, wa)
    y.backward(dy)
    F.conv2d(xb, wb, padding=1, groups=3).backward(dy)
    assert torch.allclose(xa.grad, xb.grad) and torch.allclose(wa.grad,
                                                               wb.grad)
    wa.grad = None
    dk.depthwise3x3(x, wa).backward(dy)
    assert x.grad is None and torch.allclose(wa.grad, wb.grad)
    with torch.no_grad():
        assert not dk.depthwise3x3(xa, wa).requires_grad


def test_wrappers_refuse_cpu_tensors():
    x, dy, weight = _inputs((1, 2, 3, 3))
    with pytest.raises(ValueError, match="device"):
        dk.depthwise_forward(x, weight)
    with pytest.raises(ValueError, match="device"):
        dk.depthwise_backward(dy, x, weight)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(dev, shape, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, device=dev, generator=g).to(dtype)
    dy = torch.randn(shape, device=dev, generator=g).to(dtype)
    weight = torch.randn((shape[1], 1, 3, 3), device=dev, generator=g) * 0.3
    return x, dy, weight


def _ulp(ref: torch.Tensor) -> torch.Tensor:
    """One ulp of ``ref`` at its type (float32: 2^-23 of it)."""
    bits = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}
    _, e = torch.frexp(ref.float())
    return torch.exp2((e - bits[ref.dtype]).float())


def _check_against_plain(x, dy, weight):
    """Forward and dx within one ulp of the plain versions, and float32
    round-off of the products' magnitudes (the sums run in another order
    before the one rounding); dW within 1e-5 of the products' magnitudes
    of the float64 sum; dW twice bit for bit."""
    c = x.shape[1]
    w = weight.to(x.dtype).double()
    y = dk.depthwise_forward(x, weight)
    dx, dw = dk.depthwise_backward(dy, x, weight)
    torch.cuda.synchronize()
    assert y.shape == dx.shape == x.shape and dw.shape == weight.shape
    assert y.dtype == dx.dtype == x.dtype and dw.dtype == torch.float32
    y_p = dk.depthwise3x3_ref(x, weight)
    mag = F.conv2d(x.double().abs(), w.abs(), padding=1, groups=c)
    assert bool(((y.double() - y_p.double()).abs()
                 <= _ulp(y_p) + 2e-6 * mag).all())
    dx_p, _ = dk.depthwise3x3_backward_ref(dy, x, weight)
    mag = F.conv2d(dy.double().abs(), w.abs().flip(2, 3), padding=1,
                   groups=c)
    assert bool(((dx.double() - dx_p.double()).abs()
                 <= _ulp(dx_p) + 2e-6 * mag).all())
    _, dw64 = dk.depthwise3x3_backward_ref(dy.double(), x.double(), w)
    terms = torch.nn.grad.conv2d_weight(x.double().abs(), weight.shape,
                                        dy.double().abs(), padding=1,
                                        groups=c)
    assert bool(((dw.double() - dw64).abs() <= 1e-5 * terms + 1e-7).all())
    _, dw2 = dk.depthwise_backward(dy, x, weight)
    assert torch.equal(dw, dw2)


XCEPTION_CASES = ([(256, c, s) for c, s in XCEPTION]
                  + [(3, c, s) for c, s in XCEPTION])


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,side", XCEPTION_CASES,
                         ids=[f"{n}x{c}x{s}" for n, c, s in XCEPTION_CASES])
def test_kernel_at_xception_shapes(dev, n, c, side):
    """Every Xception depthwise shape at B=256 and at a ragged B=3,
    bf16."""
    before = (dk.depthwise_forward.launches, dk.depthwise_backward.launches)
    _check_against_plain(*_card_inputs(dev, (n, c, side, side)))
    assert (dk.depthwise_forward.launches,
            dk.depthwise_backward.launches) == (before[0] + 1,
                                                before[1] + 2)


def _stride1_shapes(name):
    """(C, H, W) of the stride-1 3x3 depthwise convs of ``name`` at 224²,
    from a forward on the meta device."""
    model = build_model(ModelConfig(name=name, num_classes=7,
                                    image_size=224), device="meta")
    shapes = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: shapes.append(tuple(args[0].shape[1:])))
        for m in _stride1_3x3(model)]
    with torch.no_grad():
        model(torch.empty(1, 224, 224, 3, device="meta"))
    for h in hooks:
        h.remove()
    return sorted(set(shapes))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mobilenet_v2", "efficientnet_b0"])
def test_kernel_at_mobile_shapes(dev, name):
    """MobileNetV2's and EfficientNet-B0's stride-1 3x3 depthwise shapes
    at 224², B=32, bf16 (7x7 planes among them: narrower than a vector)."""
    shapes = _stride1_shapes(name)
    assert len(shapes) >= 3
    for c, h, w in shapes:
        _check_against_plain(*_card_inputs(dev, (32, c, h, w), seed=c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("shape", [(4, 24, 37, 37), (3, 5, 10, 10),
                                   (2, 3, 9, 150), (5, 7, 2, 3)],
                         ids=["37", "10", "9x150", "2x3"])
def test_kernel_other_dtypes(dev, shape, dtype):
    _check_against_plain(*_card_inputs(dev, shape, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["strided", "dtype", "aligned", "weight",
                                  "weight_dtype", "dy", "device"])
def test_wrapper_refuses(dev, what):
    """Non-contiguous, float64, misaligned (a contiguous view 2 bytes off
    a 16-byte boundary), a wrong weight shape or type, a dy unlike x, a
    weight on the CPU: each raises before any launch."""
    x, dy, weight = _card_inputs(dev, (2, 8, 6, 6))
    if what == "strided":
        x = x.transpose(2, 3)
    elif what == "dtype":
        x = x.double()
    elif what == "aligned":
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        x = buf[1:].view(x.shape)
    elif what == "weight":
        weight = weight[:, :, :2]
    elif what == "weight_dtype":
        weight = weight.to(torch.bfloat16)
    elif what == "dy":
        dy = dy.float()
    elif what == "device":
        weight = weight.cpu()
    before = (dk.depthwise_forward.launches, dk.depthwise_backward.launches)
    with pytest.raises(ValueError):
        if what == "dy":
            dk.depthwise_backward(dy, x, weight)
        else:
            dk.depthwise_forward(x, weight)
    assert (dk.depthwise_forward.launches,
            dk.depthwise_backward.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_xception_through_the_kernels(dev, dtype, monkeypatch):
    """xception_small (16 depthwise convs) trained one step on the card:
    each conv's forward and backward through the kernels once and none
    through F.conv2d, and the loss and every gradient close to the same
    step through F.conv2d (its depthwise dW rounded to the compute dtype
    on its way back, the kernels' kept in float32)."""
    cfg = ModelConfig(name="xception_small", num_classes=3, image_size=64,
                      compute_dtype=dtype)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    model.head_dropout = 0.0
    x = torch.rand(8, 64, 64, 3, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(1))
    labels = torch.arange(8, device=dev) % 3
    groups = []
    conv2d = F.conv2d

    def spy(*args, **kw):
        groups.append(kw.get("groups", 1))
        return conv2d(*args, **kw)

    def step():
        model.zero_grad()
        loss = F.nll_loss(model(x, train=False), labels)
        loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in model.named_parameters()}

    n_dw = len(_stride1_3x3(model))
    assert n_dw == 16
    monkeypatch.setattr(F, "conv2d", spy)
    dk.depthwise_forward.launches = dk.depthwise_backward.launches = 0
    loss, grads = step()
    torch.cuda.synchronize()
    assert (dk.depthwise_forward.launches,
            dk.depthwise_backward.launches) == (n_dw, n_dw)
    assert groups and set(groups) == {1}
    monkeypatch.setattr(resnet.Conv, "depthwise3x3", lambda *a: False)
    groups.clear()
    loss_p, grads_p = step()
    assert groups.count(1) < len(groups)
    # the loss within bf16's or float32's round-off; each gradient within
    # 8e-2 (bf16) or 1e-2 (float32) of its largest element: the two paths
    # sum in other orders, so a max pool's nearly tied window can route a
    # gradient to the other input, and float32's stem gradient moved by
    # 6.9e-4 of its largest on an H100
    tol, grad_tol = (2e-2, 8e-2) if dtype == "bfloat16" else (1e-4, 1e-2)
    assert abs(float(loss) - float(loss_p)) <= tol * abs(float(loss_p))
    for name, g in grads.items():
        scale = float(grads_p[name].abs().max()) + 1e-12
        assert float((g - grads_p[name]).abs().max()) <= grad_tol * scale, \
            name

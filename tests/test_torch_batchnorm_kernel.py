"""The fused BatchNorm's plain versions, launch plan and dispatch, on the
CPU (``ops.kernels.batchnorm_kernel``; the kernels themselves run in the
``cuda`` cases of ``tests/test_torch_cuda.py``).

The plain forward is the float32 chain that ``models.resnet.BatchNorm``
runs on the CPU, held to the chain as it was before the kernels (the same
bits, the same exported graph). The closed-form backward is held to
autograd through it, in float32 and in float64."""

import types

import pytest
import torch
import torch.nn.functional as F

from skin_image_analysis_tpu_torch.models import resnet
from skin_image_analysis_tpu_torch.ops.kernels import batchnorm_kernel as bk
from tests.test_torch_pooling import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MOMENTUM, EPS = 0.99, 1e-5
#: a channel held at this value has E[x^2] - E[x]^2 < 0 in float32 and
#: float64 over [4, ., 5, 5], so the clamp on the variance bites there
CLAMPED = 3.3
EPILOGUES = {"none": (False, False), "relu": (True, False),
             "residual": (True, True)}


def _inputs(dtype, shape=(4, 5, 5, 5), seed=0, clamp=True):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = shape
    x = (torch.randn(shape, generator=g) * 1.5 + 0.3).to(dtype)
    if clamp:
        x[:, 1] = CLAMPED
    weight = (torch.rand(c, generator=g) + 0.5).to(dtype)
    bias = (torch.randn(c, generator=g) * 0.2).to(dtype)
    rm = (torch.randn(c, generator=g) * 0.1).to(dtype)
    rv = (torch.rand(c, generator=g) + 0.5).to(dtype)
    residual = torch.randn(shape, generator=g).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    return x, weight, bias, rm, rv, residual, dy


def _module(c, weight, bias, rm, rv):
    bn = resnet.BatchNorm(c, "float32")
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(rm)
        bn.running_var.copy_(rv)
    return bn


def _plain(x, weight, bias, rm, rv, train, relu, residual):
    """The plain forward: (y, mean, rstd, varg) with varg None in eval."""
    y, mean, rstd, raw = bk.batchnorm_ref(
        x, weight, bias, rm, rv, train=train, momentum=MOMENTUM, eps=EPS,
        relu=relu, residual=residual)
    return y, mean, rstd, None if raw is None else (raw >= 0).to(raw.dtype)


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", [(4, 5, 5, 5), (3, 9, 7, 7)],
                         ids=["5x5", "7x7"])
def test_plain_against_module_float32(shape, train, epilogue):
    """The module's CPU path is the plain forward (the same bits and
    running averages); the closed-form backward equals autograd through
    it within float32 round-off (its sums run in another order). The 5x5 case has a channel whose variance
    clamps to 0, where the closed form drops the variance's gradient as
    ``clamp_min``'s backward does."""
    relu, res = EPILOGUES[epilogue]
    x, weight, bias, rm, rv, residual, dy = _inputs(
        torch.float32, shape, clamp=shape[1] == 5)
    residual = residual if res else None
    bn = _module(shape[1], weight, bias, rm, rv)
    xm = x.clone().requires_grad_()
    rm_ = residual.clone().requires_grad_() if res else None
    want = bn(xm, train, relu=relu, residual=rm_)
    want.backward(dy)

    rm2, rv2 = rm.clone(), rv.clone()
    y, mean, rstd, varg = _plain(x, weight, bias, rm2, rv2, train, relu,
                                 residual)
    assert torch.equal(y, want.detach())
    assert torch.equal(rm2, bn.running_mean)
    assert torch.equal(rv2, bn.running_var)
    if train and shape[1] == 5:
        assert varg[1] == 0 and varg.sum() == shape[1] - 1

    dx, dw, db, dres = bk.batchnorm_backward_ref(
        dy, x, y, weight, mean, rstd, varg, relu=relu, residual=res)
    for got, ref in ((dx, xm.grad), (dw, bn.weight.grad),
                     (db, bn.bias.grad)):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 2e-5 * max(scale, 1.0)
    if res:
        assert torch.equal(dres, rm_.grad)
    else:
        assert dres is None


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_closed_form_backward_float64(train, epilogue):
    """In float64 the closed-form backward equals autograd through the
    plain forward to 1e-12, the clamped channel included."""
    relu, res = EPILOGUES[epilogue]
    x, weight, bias, rm, rv, residual, dy = _inputs(torch.float64)
    xg = x.clone().requires_grad_()
    wg = weight.clone().requires_grad_()
    bg = bias.clone().requires_grad_()
    rg = residual.clone().requires_grad_() if res else None
    y, mean, rstd, varg = _plain(xg, wg, bg, rm.clone(), rv.clone(), train,
                                 relu, rg)
    y.backward(dy)
    if train:
        assert varg[1] == 0
    dx, dw, db, dres = bk.batchnorm_backward_ref(
        dy, x, y.detach(), weight, mean.detach(), rstd.detach(), varg,
        relu=relu, residual=res)
    for got, ref in ((dx, xg.grad), (dw, wg.grad), (db, bg.grad)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)
    if res:
        torch.testing.assert_close(dres, rg.grad, rtol=0, atol=0)


def _old_chain(bn, x, train, relu=False, residual=None):
    """``BatchNorm.forward`` as it was before the kernels, then the
    block's residual add and ReLU as ``_Block.forward`` ran them."""
    xf = x.float()
    if train:
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3))
                              - mean * mean, 0.0)
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
            bn.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias[:, None, None]
    y = y.to(bn.compute_dtype)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


class _Run(torch.nn.Module):
    def __init__(self, bn, fn):
        super().__init__()
        self.bn, self.fn = bn, fn

    def forward(self, x, *residual):
        return self.fn(self.bn, x, *residual)


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_chain_is_the_old_one(train, epilogue):
    """The CPU (and mesh and export) path runs the chain that was there
    before the kernels: a bf16 BatchNorm gives the old chain's bits, its
    running averages and its gradients, and ``torch.export`` records the
    same operations in the same order."""
    relu, res = EPILOGUES[epilogue]
    x, weight, bias, rm, rv, residual, dy = _inputs(torch.float32)
    x, residual, dy = (t.bfloat16() for t in (x, residual, dy))
    mods = {}
    for name in ("new", "old"):
        bn = resnet.BatchNorm(5, "bfloat16")
        with torch.no_grad():
            for t, v in ((bn.weight, weight), (bn.bias, bias),
                         (bn.running_mean, rm), (bn.running_var, rv)):
                t.copy_(v)
        mods[name] = bn

    def new(bn, x, *r):
        return bn(x, train, relu=relu, residual=r[0] if r else None)

    def old(bn, x, *r):
        return _old_chain(bn, x, train, relu, r[0] if r else None)

    outs, grads, graphs = {}, {}, {}
    for name, fn in (("new", new), ("old", old)):
        xg = x.clone().requires_grad_()
        rg = (residual.clone().requires_grad_(),) if res else ()
        outs[name] = fn(mods[name], xg, *rg)
        outs[name].backward(dy)
        grads[name] = [xg.grad, mods[name].weight.grad,
                       mods[name].bias.grad] + [r.grad for r in rg]
        ep = torch.export.export(_Run(mods[name], fn),
                                 (x, *([residual] if res else [])))
        graphs[name] = [str(n.target) for n in ep.graph.nodes
                        if n.op == "call_function"]
    assert torch.equal(outs["new"], outs["old"])
    for a, b in zip(grads["new"], grads["old"]):
        assert torch.equal(a, b)
    for k in ("running_mean", "running_var"):
        assert torch.equal(getattr(mods["new"], k), getattr(mods["old"], k))
    assert graphs["new"] == graphs["old"] and graphs["new"]


def _resnet50_shapes():
    """(C, H*W, whether it ends a block with the residual) of each of
    ResNet-50's BatchNorm calls at 224², in forward order, from a B=1
    forward of the CPU model."""
    model = resnet.resnet50(num_classes=7, compute_dtype="float32")
    shapes = []

    def record(m, args, kwargs):
        x = args[0]
        shapes.append((x.shape[1], x.shape[2] * x.shape[3],
                       kwargs.get("residual") is not None))

    hooks = [m.register_forward_pre_hook(record, with_kwargs=True)
             for m in model.modules() if isinstance(m, resnet.BatchNorm)]
    with torch.no_grad():
        model(torch.zeros(1, 224, 224, 3))
    for h in hooks:
        h.remove()
    return shapes


@pytest.fixture(scope="module")
def resnet50_shapes():
    shapes = _resnet50_shapes()
    assert len(shapes) == 53 and sum(r for *_, r in shapes) == 16
    return shapes


@pytest.mark.parametrize("batch", [256, 1])
@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "f32"])
def test_plane_plan_over_resnet50(resnet50_shapes, batch, elem_bytes):
    """Every ResNet-50 BatchNorm shape's segments cover a plane
    exactly, in 16-byte multiples where cut; its chunks cover the rows;
    the grid fits CUDA's limits; at B=256 every layer gets the 1,024
    blocks the plan aims for, with whole planes as rows."""
    vec = 16 // elem_bytes
    for c, hw, _ in resnet50_shapes:
        p = bk.bn_plan(batch, c, hw, elem_bytes)
        assert p.segments * p.seg_len >= hw > (p.segments - 1) * p.seg_len
        if p.segments > 1:
            assert p.seg_len % vec == 0 and p.seg_len >= bk.SEG_MIN
        assert p.rows == batch * p.segments
        assert p.chunks == -(-p.rows // p.rows_per_chunk) <= 65535
        assert (p.chunks - 1) * p.rows_per_chunk < p.rows
        assert p.channel_blocks == -(-c // bk.WARPS)
        assert p.args() == [p.segments, p.seg_len, p.rows_per_chunk,
                            p.chunks]
        if batch == 256:
            assert p.segments == 1 and p.blocks == bk.TARGET_BLOCKS
        else:
            assert p.rows_per_chunk == 1
            assert p.channel_blocks <= p.blocks <= bk.TARGET_BLOCKS


def test_plan_odd_shapes():
    """Shapes the ResNet does not have: C not a multiple of 8, H*W of 9
    and 49, N=1, and a plane cut into segments whose last is short."""
    assert bk.bn_plan(1, 3, 9) == bk.PlanePlan(1, 9, 1, 1, 1, 1)
    assert bk.bn_plan(3, 13, 49) == bk.PlanePlan(1, 49, 3, 1, 3, 2)
    p = bk.bn_plan(1, 8, 5000)
    assert (p.segments, p.seg_len) == (4, 1256)
    assert 3 * 1256 < 5000 <= 4 * 1256
    p = bk.bn_plan(1, 8, 5000, 4)
    assert p.seg_len % 4 == 0
    for bad in ((0, 8, 9), (1, 0, 9), (1, 8, 0)):
        with pytest.raises(ValueError):
            bk.bn_plan(*bad)
    with pytest.raises(ValueError):
        bk.bn_plan(1, 8, 9, elem_bytes=8)


def test_bytes_match_the_sizing(resnet50_shapes):
    """ResNet-50 at B=256 has 11.11 M BatchNorm activations an image:
    the train forward's two-pass floor is 17 GB plus 2.8 GB for the 16
    residual reads; the backward's is 28.5 GB for x and dy read twice and
    dx written, plus 8.4 GB behind the residuals (the output read twice,
    the residual's gradient written)."""
    elems = sum(c * hw for c, hw, _ in resnet50_shapes)
    assert 11.10e6 < elems < 11.12e6
    fwd = sum(bk.bn_bytes(256, c, hw, form="train", passes=2)
              for c, hw, _ in resnet50_shapes)
    res_reads = sum(bk.bn_bytes(256, c, hw, form="train", passes=2,
                                residual=True)
                    - bk.bn_bytes(256, c, hw, form="train", passes=2)
                    for c, hw, res in resnet50_shapes if res)
    assert 17.0e9 < fwd < 17.2e9 and 2.7e9 < res_reads < 2.9e9
    bwd = sum(bk.bn_bytes(256, c, hw, form="backward", passes=2)
              for c, hw, _ in resnet50_shapes)
    behind = sum(bk.bn_bytes(256, c, hw, form="backward", passes=2,
                             relu=True, residual=True)
                 - bk.bn_bytes(256, c, hw, form="backward", passes=2)
                 for c, hw, res in resnet50_shapes if res)
    assert 28.4e9 < bwd < 28.6e9 and behind == 3 * res_reads
    assert bk.bn_bytes(1, 1, 8, 2, form="eval") == 32
    assert bk.bn_bytes(1, 1, 8, 2, form="backward") == 48
    assert bk.bn_bytes(1, 1, 8, 2, form="backward", passes=2) == 80
    with pytest.raises(ValueError):
        bk.bn_bytes(1, 1, 8, form="apply")


CUDA_LIKE = types.SimpleNamespace(device=torch.device("cuda"))


def test_dispatch_rules():
    """A CUDA tensor takes the kernels; a CPU tensor, a train forward
    under a mesh's statistics, and a trace take the chain."""
    assert resnet._fused(CUDA_LIKE, True) and resnet._fused(CUDA_LIKE, False)
    assert not resnet._fused(torch.zeros(1), True)
    assert not resnet._fused(torch.zeros(1), False)
    with resnet.global_batch_stats(object()):
        assert not resnet._fused(CUDA_LIKE, True)
        assert resnet._fused(CUDA_LIKE, False)


def test_cpu_tensor_takes_the_chain(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the kernels' entry ran on a CPU tensor")

    monkeypatch.setattr(bk, "batchnorm", refuse)
    x, weight, bias, rm, rv, residual, _ = _inputs(torch.float32)
    bn = _module(5, weight, bias, rm, rv)
    for train in (True, False):
        bn(x, train, relu=True, residual=residual)


def test_export_trace_takes_the_chain(monkeypatch):
    """While ``torch.export`` traces (non-strict, as ``serve/export.py``
    and ``serve/trace.py`` export), a CUDA tensor would take the chain;
    outside the trace it would take the kernels."""
    seen = []
    forward = resnet.BatchNorm.forward

    def spy(self, x, train, relu=False, residual=None):
        seen.append(resnet._fused(CUDA_LIKE, train))
        return forward(self, x, train, relu, residual)

    monkeypatch.setattr(resnet.BatchNorm, "forward", spy)
    model = resnet.resnet18(num_classes=2, compute_dtype="float32").eval()

    class Eval(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, x):
            return self.model(x)

    torch.export.export(Eval(), (torch.zeros(1, 32, 32, 3),))
    assert len(seen) == 20 and not any(seen)
    seen.clear()
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    assert len(seen) == 20 and all(seen)


def _old_block(block, x, train):
    """``_Block.forward`` as it was before the epilogues: each BatchNorm
    plain, then F.relu, and relu(y + residual) at the end."""
    y = x
    for i in range(block.n_convs):
        y = getattr(block, f"bn{i}")(getattr(block, f"conv{i}")(y), train)
        if i < block.n_convs - 1:
            y = F.relu(y)
    residual = x
    if block.downsample_conv is not None:
        residual = block.downsample_bn(block.downsample_conv(x), train)
    return F.relu(y + residual)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_resnet50_epilogue_equals_old_block(dtype):
    """A resnet50 CPU forward through the epilogue arguments equals the
    old block's F.relu calls bit for bit: features, log-probs and every
    running average, in train and in eval."""
    torch.manual_seed(0)
    new = resnet.resnet50(num_classes=7, compute_dtype=dtype)
    new.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in new.modules():
            if isinstance(m, resnet.BatchNorm):
                m.weight.uniform_(0.5, 1.0)
                m.bias.uniform_(-0.1, 0.1)
    old = resnet.resnet50(num_classes=7, compute_dtype=dtype)
    old.load_state_dict(new.state_dict())

    def old_features(x, train):
        x = x.permute(0, 3, 1, 2).to(old.compute_dtype)
        x = F.relu(old.stem_bn(old.stem_conv(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for block in old.blocks:
            x = _old_block(block, x, train)
        return x

    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for train in (True, False):
            got = new.features(x, train)
            want = old_features(x, train)
            assert torch.equal(got, want)
            assert torch.equal(new.classify(got, False, None),
                               old.classify(want, False, None))
    for (k, a), (_, b) in zip(new.state_dict().items(),
                              old.state_dict().items()):
        assert torch.equal(a, b), k

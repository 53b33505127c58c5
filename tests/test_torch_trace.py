"""The port's quantization-graph capture (``serve/trace.py``) against the
JAX package's ``serve.trace``, on the CPU: the captured records' kinds,
keys and order on one flagship's weights in both packages (the structural
ops: contractions, activations, pools, reshapes), their kernels tensor
for tensor; the float replay against the live model for the flagship, a
probe family with every captured form, and resnet18; the trace file;
and the |x| quantile of percentile calibration against ``jnp.quantile``.

Tolerances: kernels exactly equal after the layout change (HWIO ->
OIHW), the float replay within 1e-5 of the live float32 forward, the
probe's int8 program within 0.1 of its float log-probs (three int8
contractions), the quantile within 1e-6 relative.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu.config import ModelConfig as JModelConfig
from skin_image_analysis_tpu.serve import trace as jtrace
from skin_image_analysis_tpu_torch.bridge import state_dict_to_flax
from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.serve import quantize as tq
from skin_image_analysis_tpu_torch.serve import trace as ttrace
from tests.test_torch_serve import FLAGSHIP, pixels
from tests.test_torch_pooling import one_torch_thread  # noqa: F401

#: the record kinds whose sequence the two captures share (the port's
#: graph adds the NHWC -> NCHW transpose; jaxprs spell out log_softmax)
STRUCTURAL = ("conv", "dense", "act", "maxpool", "reshape")
KEYS = {
    "conv": {"op", "in", "kernel", "strides", "padding", "groups",
             "quantize"},
    "dense": {"op", "in", "kernel", "quantize"},
    "act": {"op", "kind", "in"},
    "maxpool": {"op", "in", "window", "strides", "padding"},
    "reshape": {"op", "in", "tail"},
}


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def graphs():
    """(JAX graph, port graph, ModelConfig, state_dict) of one seeded
    flagship, its weights in both packages' layouts."""
    tcfg = ModelConfig(**FLAGSHIP)
    sd = build_model(tcfg, device="cpu",
                     generator=torch.Generator().manual_seed(3)).state_dict()
    jparams = jax.tree.map(jnp.asarray, state_dict_to_flax(
        sd, FLAGSHIP["image_size"]))
    return (jtrace.trace_graph(JModelConfig(**FLAGSHIP), jparams),
            ttrace.trace_graph(tcfg, sd), tcfg, sd)


def test_trace_records_keys_and_order(graphs):
    jg, tg, _, _ = graphs
    js = [op for op in jg.ops if op["op"] in STRUCTURAL]
    ts = [op for op in tg.ops if op["op"] in STRUCTURAL]
    assert [(o["op"], o.get("kind"), o.get("quantize")) for o in ts] == \
        [(o["op"], o.get("kind"), o.get("quantize")) for o in js]
    for j, t in zip(js, ts):
        assert set(t) == set(j) == KEYS[t["op"]]
        if t["op"] == "conv":
            np.testing.assert_array_equal(
                t["kernel"].numpy(), j["kernel"].transpose(3, 2, 0, 1))
            assert t["strides"] == j["strides"]
            assert t["padding"] == j["padding"]
            assert t["groups"] == j["groups"]
        elif t["op"] == "maxpool":
            nhwc = tuple(t["padding"][d] for d in (0, 2, 3, 1))
            assert (t["window"], t["strides"], nhwc) == (
                j["window"], j["strides"], j["padding"])
        elif t["op"] == "dense" and t is not next(
                o for o in ts if o["op"] == "dense"):
            np.testing.assert_array_equal(t["kernel"].numpy(), j["kernel"])
    # the port's full record sequence: transpose, per block conv + bias +
    # relu + pool, the flatten, per dense dense + bias (+ relu), softmax
    n_conv, n_lin = len(FLAGSHIP["conv_features"]), len(
        FLAGSHIP["linear_features"])
    want = (["transpose"] + ["conv", "ew", "act", "maxpool"] * n_conv
            + ["reshape"] + ["dense", "ew", "act"] * n_lin
            + ["dense", "ew", "log_softmax"])
    assert [o["op"] for o in tg.ops] == want
    assert tg.out == len(tg.ops)


def test_graph_forward_matches_jax_graph(graphs):
    jg, tg, _, _ = graphs
    px = pixels(4, seed=7).astype(np.float32) / 255.0
    want, jmax = map(np.asarray, jax.jit(
        lambda v: jtrace.graph_forward(jg, v, taps=True))(jnp.asarray(px)))
    got = ttrace.graph_forward(tg, torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    tmax = ttrace.graph_forward(tg, torch.from_numpy(px), taps=True)[1]
    # tensor 0 and the output; the port's tensor 1 is its transpose
    np.testing.assert_allclose(tmax[[0, -1]].numpy(), jmax[[0, -1]],
                               rtol=1e-5)


class Probe(torch.nn.Module):
    """A small family with one of each captured form: conv + BatchNorm
    module + relu6, an asymmetric pad, a depthwise stride-2 conv + swish,
    a squeeze-excite gate (mean, 1x1 convs, sigmoid, mul), a max-pool,
    the flatten and a linear head. Its ``nn.BatchNorm2d`` exports as
    ``aten.batch_norm``, which sends the capture down its core-ATen
    fallback (``run_decompositions``): the other families take the
    direct walk."""

    def __init__(self, cfg, device=None):
        super().__init__()
        nn = torch.nn
        self.conv = nn.Conv2d(3, 6, 3, padding=1, device=device)
        self.bn = nn.BatchNorm2d(6, device=device)
        self.dw = nn.Conv2d(6, 6, 3, stride=2, groups=6, device=device)
        self.se1 = nn.Conv2d(6, 2, 1, device=device)
        self.se2 = nn.Conv2d(2, 6, 1, device=device)
        side = cfg.image_size // 4
        self.fc = nn.Linear(6 * side * side, cfg.num_classes, device=device)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for p in self.parameters():
                p.normal_(0.0, 0.3, generator=generator)

    def forward(self, x, train=False):
        F = torch.nn.functional
        x = F.relu6(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        x = F.silu(self.dw(F.pad(x, (0, 1, 0, 1))))
        gate = torch.sigmoid(self.se2(F.relu(self.se1(
            x.mean((2, 3), keepdim=True)))))
        x = F.max_pool2d(x * gate, 2)
        return F.log_softmax(self.fc(x.flatten(1)), dim=-1)


@pytest.fixture(scope="module")
def probe_family():
    from skin_image_analysis_tpu_torch.models import registry

    registry.register_model("trace_probe")(Probe)
    try:
        yield "trace_probe"
    finally:
        del registry._REGISTRY["trace_probe"]


@pytest.mark.parametrize("name,size", [
    ("skin_cancer_list", 16), ("trace_probe", 16), ("resnet18", 32)])
def test_graph_forward_matches_live_model(probe_family, name, size):
    """The float replay is the model: the flagship, the probe family
    (relu6, pads, depthwise, swish, squeeze-excite, a BatchNorm module)
    and resnet18 (the port's BatchNorm, residuals), with random BatchNorm
    statistics."""
    kw = dict(FLAGSHIP) if name == "skin_cancer_list" else {}
    cfg = ModelConfig(**{**kw, "name": name, "image_size": size,
                         "compute_dtype": "float32"})
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
    sd = model.state_dict()
    graph = ttrace.trace_graph(cfg, sd)
    x = torch.from_numpy(pixels(3, size, seed=2).astype(np.float32) / 255)
    model.eval()
    with torch.no_grad():
        want = model(x, train=False).float()
    got = ttrace.graph_forward(graph, x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    kinds = {o.get("kind") for o in graph.ops if o["op"] == "act"}
    if name == "trace_probe":
        assert {"relu", "relu6", "swish"} <= kinds
        assert {"pad", "reduce", "maxpool"} <= {o["op"] for o in graph.ops}
        # squeeze-excite convs read 1x1 maps and stay float32
        assert [o["quantize"] for o in graph.ops if o["op"] == "conv"] == [
            True, True, False, False]
        # the int8 program of the probe tracks its float graph
        qtree = tq.quantize_model(cfg, sd, pixels(6, size, seed=5),
                                  device="cpu")
        q = tq.build_infer_fn_quantized(qtree, device="cpu")(
            torch.from_numpy(pixels(3, size, seed=2)))["log_probs"]
        torch.testing.assert_close(q, want, atol=0.1, rtol=0)


def test_write_graph_jsonl(graphs, tmp_path):
    _, tg, tcfg, sd = graphs
    path = str(tmp_path / "graph.jsonl")
    assert ttrace.write_graph_jsonl(tg.ops, path) == len(tg.ops)
    with open(path) as f:
        records = [json.loads(line) for line in f]
    assert [r["index"] for r in records] == list(range(1, len(tg.ops) + 1))
    assert [list(r)[:2] for r in records] == [["index", "op"]] * len(records)
    conv = records[1]
    assert conv["op"] == "conv" and conv["kernel"] == {
        "shape": list(tg.ops[1]["kernel"].shape), "dtype": "float32"}
    qtree = tq.quantize_model(tcfg, sd, pixels(8, seed=4), device="cpu")
    qpath = str(tmp_path / "int8.jsonl")
    ttrace.write_graph_jsonl(qtree["ops"], qpath)
    with open(qpath) as f:
        qrec = [json.loads(line) for line in f]
    assert [r["op"] for r in qrec] == [r["op"] for r in records]
    quantized = [r for r in qrec if "kernel_q" in r]
    assert len(quantized) == len(FLAGSHIP["conv_features"]) + len(
        FLAGSHIP["linear_features"]) + 1
    assert {r["kernel_q"]["dtype"] for r in quantized} == {"int8"}
    assert all(isinstance(r["in_scale"], float) for r in quantized)


def test_abs_quantile_matches_jnp():
    x = np.random.default_rng(0).normal(size=(3, 5, 7, 11)).astype(
        np.float32)
    for q in (0.5, 0.99, 0.999, 1.0):
        want = float(jnp.quantile(jnp.abs(jnp.asarray(x)).ravel(), q))
        got = float(ttrace.abs_quantile(torch.from_numpy(x), q))
        assert got == pytest.approx(want, rel=1e-6)


def test_capture_refuses_non_rgb():
    cfg = ModelConfig(**{**FLAGSHIP, "in_channels": 2})
    with pytest.raises(ValueError, match="RGB"):
        ttrace.trace_graph(cfg, {})

"""Quantization-graph capture: trace a registered model's eval forward
into the int8 graph IR (port of the JAX package's ``serve.trace``).

The model is rebuilt with ``compute_dtype=float32``, the stock pool
(ReLU + ``max_pool2d``) and no remat, loaded with the checkpoint, and
traced at batch 1 with ``torch.export``; its core-ATen decomposition
(``run_decompositions``, an op set that holds across PyTorch releases) is
then walked node by node. Every node whose
inputs are all weights is evaluated on the spot (constant folding: the
weight casts and transposes); every input-dependent node becomes one
record of the IR, a dict with the JAX package's op kinds and keys:

- ``conv`` (``in``, ``kernel`` OIHW, ``strides``, ``padding`` as
  ``((lo, hi), (lo, hi))``, ``groups``, ``quantize``) and ``dense``
  (``in``, ``kernel`` ``[in, out]``, ``quantize``); a conv's or a
  linear's bias rides as the ``ew`` add that follows it, as Flax emits
  it;
- ``act`` (``kind`` relu | relu6 | swish), ``maxpool`` (``window``,
  ``strides``, ``padding`` of every dim), ``ew`` (``fn``, ``args``: ``("t", index)``
  or ``("c", tensor)``), ``reduce`` (``fn`` sum | max | min | mean,
  ``axes``), ``reshape`` / ``broadcast`` (``tail``), ``transpose``
  (``perm``), ``squeeze`` (``dims``), ``pad`` (``config``, ``value``);
- ``log_softmax`` (``axis``): ATen keeps the head's log-softmax as one
  op where jaxprs spell it out in primitives.

``ops[i]`` produces tensor ``i + 1``; tensor 0 is the NHWC model input.
The layout is the port's: the graph opens with the model's NHWC -> NCHW
transpose, convs run NCHW with OIHW kernels (the JAX package's are NHWC /
HWIO), so a conv's output channel is axis 1 of its tensor and axis 0 of
its kernel. Quantization points are the JAX package's: contractions
quantize unless their input is spatially 1x1 (squeeze-excite internals);
BatchNorm is not folded (its eval form rides as ``ew`` sub, mul, add).

:func:`graph_forward` replays the IR in float32; it is the calibration
pass and the fidelity oracle (``taps=True`` adds each tensor's max|x| or
an |x| quantile). :func:`write_graph_jsonl` writes the IR as JSON lines,
one record per op with its arrays given by shape and dtype.

Left out of the JAX module: the jaxpr machinery (inlining of ``pjit`` and
``custom_jvp`` calls, the lazy ``broadcast_in_dim`` of host constants and
its numpy evaluator), which ``torch.export``'s flat ATen graph and
PyTorch's own ops on constant tensors replace; and the pre-check that a
BatchNorm family has its ``batch_stats``, since a port checkpoint holds
the running statistics as buffers of the same state dict.
"""

from __future__ import annotations

import json
import operator
from dataclasses import dataclass, field, replace

import torch
import torch.nn.functional as F

aten = torch.ops.aten

#: elementwise ATen ops -> the IR's ``fn`` name
_EW_BINARY = {
    aten.add.Tensor: "add", aten.add.Scalar: "add",
    aten.sub.Tensor: "sub", aten.sub.Scalar: "sub",
    aten.rsub.Scalar: "rsub", aten.rsub.Tensor: "rsub",
    aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
    aten.div.Tensor: "div", aten.div.Scalar: "div",
    aten.maximum.default: "max", aten.minimum.default: "min",
    aten.pow.Tensor_Scalar: "pow", aten.pow.Tensor_Tensor: "pow",
}
_EW_UNARY = {
    aten.exp.default: "exp", aten.log.default: "log",
    aten.rsqrt.default: "rsqrt", aten.sqrt.default: "sqrt",
    aten.neg.default: "neg", aten.abs.default: "abs",
    aten.sigmoid.default: "logistic", aten.tanh.default: "tanh",
    aten.sign.default: "sign", aten.floor.default: "floor",
    aten.ceil.default: "ceil", aten.round.default: "round",
    aten.erf.default: "erf", aten.log1p.default: "log1p",
    aten.expm1.default: "expm1",
}
_BINARY_FNS = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "max": torch.maximum, "min": torch.minimum,
    "pow": torch.pow, "rsub": lambda a, b: b - a,
}
_UNARY_FNS = {
    "exp": torch.exp, "log": torch.log, "rsqrt": torch.rsqrt,
    "sqrt": torch.sqrt, "neg": torch.neg, "abs": torch.abs,
    "logistic": torch.sigmoid, "tanh": torch.tanh, "sign": torch.sign,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "erf": torch.erf, "log1p": torch.log1p, "expm1": torch.expm1,
}
ACTIVATIONS = {"relu": F.relu, "relu6": F.relu6, "swish": F.silu}
#: ATen ops that pass their input through unchanged
_ALIASES = {aten.clone.default, aten.alias.default, aten.detach.default,
            aten.contiguous.default, aten.lift_fresh_copy.default}
#: ATen ops that only check metadata and produce nothing
_CHECKS = {aten._assert_tensor_metadata.default}


@dataclass(frozen=True)
class _Sym:
    """An input-dependent tensor: its index in the IR and its traced
    (batch 1) shape."""

    idx: int
    shape: tuple


@dataclass
class Graph:
    """Captured eval-forward graph. ``ops[i]`` produces tensor ``i+1``
    (tensor 0 is the NHWC model input); ``out`` is the index of the
    model output (log-probs)."""

    ops: list = field(default_factory=list)
    out: int = 0


class _Builder:
    def __init__(self):
        self.ops: list[dict] = []

    def emit(self, op: dict, shape) -> _Sym:
        self.ops.append(op)
        return _Sym(len(self.ops), tuple(shape))

    def producer(self, t: int) -> dict | None:
        return self.ops[t - 1] if t >= 1 else None


def _ref(v):
    """An operand of an ``ew`` op: a tensor index, or a float32 constant
    that broadcasts against the batched tensor."""
    if isinstance(v, _Sym):
        return ("t", v.idx)
    return ("c", torch.as_tensor(v, dtype=torch.float32).detach().clone())


def _batch_free(name: str, dims, ndim: int) -> tuple:
    dims = tuple(int(d) % ndim for d in dims)
    if 0 in dims:
        raise NotImplementedError(
            f"quantization capture: {name} touches the batch dimension "
            f"({dims}); the batch-generic replay cannot represent it")
    return dims


def _shape(node) -> tuple:
    val = node.meta.get("val")
    return tuple(int(s) for s in val.shape)


class _Walker:
    def __init__(self, ep):
        self.b = _Builder()
        self.env: dict = {}
        consts = {**ep.state_dict, **ep.constants}
        sig = ep.graph_signature
        user = set(sig.user_inputs)
        targets = {s.arg.name: s.target for s in sig.input_specs
                   if s.target is not None}
        self.ep = ep
        self.consts = {name: consts[t].detach().float()
                       if consts[t].is_floating_point()
                       else consts[t].detach()
                       for name, t in targets.items()}
        self.user = user

    def value(self, a):
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        if isinstance(a, (list, tuple)):
            return type(a)(self.value(x) for x in a)
        return a

    def run(self) -> _Sym:
        out = None
        for node in self.ep.graph.nodes:
            if node.op == "placeholder":
                if node.name in self.user:
                    self.env[node] = _Sym(0, _shape(node))
                else:
                    self.env[node] = self.consts[node.name]
            elif node.op == "call_function":
                self.env[node] = self.call(node)
            elif node.op == "output":
                (outs,) = node.args
                outs = outs if isinstance(outs, (list, tuple)) else [outs]
                if len(outs) != 1:
                    raise NotImplementedError(
                        "model forward must return one tensor")
                out = self.env[outs[0]]
        if not isinstance(out, _Sym):
            raise NotImplementedError(
                "model forward must return one input-dependent tensor")
        return out

    def call(self, node):
        target = node.target
        args = self.value(node.args)
        kwargs = {k: self.value(v) for k, v in node.kwargs.items()}
        if target in _CHECKS:
            return None
        if target is operator.getitem:
            seq, i = args
            return seq[i]
        flat = list(args) + list(kwargs.values())
        syms = [a for a in _flatten(flat) if isinstance(a, _Sym)]
        if not syms:
            with torch.no_grad():
                return target(*args, **kwargs)
        return self.sym(target, node, args, kwargs)

    # -- input-dependent nodes -----------------------------------------

    def sym(self, target, node, args, kwargs):
        b = self.b
        shape = None if node.meta.get("val") is None or isinstance(
            node.meta["val"], (list, tuple)) else _shape(node)

        if target in _ALIASES:
            return args[0]
        if target == aten._to_copy.default:
            a = args[0]
            dtype = kwargs.get("dtype")
            if dtype is None or dtype == torch.float32:
                return a
            return b.emit({"op": "ew", "fn": "convert",
                           "dtype": str(dtype).replace("torch.", ""),
                           "args": [_ref(a)]}, shape)

        if target == aten.convolution.default:
            x, w, bias, stride, pad, dil, transposed, _, groups = args
            if not isinstance(x, _Sym) or isinstance(w, _Sym):
                raise NotImplementedError(
                    "conv with an input-dependent kernel")
            if transposed or any(d != 1 for d in dil) or len(stride) != 2:
                raise NotImplementedError(
                    "transposed, dilated or non-2D convolution")
            conv_shape = (shape[0], shape[1], shape[2], shape[3])
            pad = tuple(p if isinstance(p, tuple) else (int(p), int(p))
                        for p in pad) * (2 // len(pad))
            y = b.emit({
                "op": "conv", "in": x.idx, "kernel": w.float().clone(),
                "strides": tuple(int(s) for s in stride),
                "padding": pad,
                "groups": int(groups),
                # spatially-1x1 inputs are squeeze-excite internals:
                # negligible FLOPs feeding a sigmoid gate, kept float32
                "quantize": x.shape[2] * x.shape[3] > 1,
            }, conv_shape)
            if bias is None:
                return y
            return b.emit({"op": "ew", "fn": "add", "args": [
                ("t", y.idx), _ref(bias.float().reshape(1, -1, 1, 1))]},
                conv_shape)

        if target in (aten.addmm.default, aten.mm.default):
            if target == aten.addmm.default:
                bias, x, w_t = args[:3]
                if kwargs.get("beta", 1) != 1 or kwargs.get("alpha", 1) != 1:
                    raise NotImplementedError("addmm with alpha/beta")
            else:
                (x, w_t), bias = args, None
            if not isinstance(x, _Sym) or isinstance(w_t, _Sym) \
                    or len(x.shape) != 2:
                raise NotImplementedError(
                    "dense with an input-dependent kernel or a non-2D "
                    "input")
            y = b.emit({"op": "dense", "in": x.idx,
                        "kernel": w_t.float().contiguous().clone(),
                        "quantize": True}, shape)
            if bias is None:
                return y
            return b.emit({"op": "ew", "fn": "add",
                           "args": [("t", y.idx), _ref(bias.float())]},
                          shape)

        if target == aten.max_pool2d_with_indices.default:
            x, window = args[0], args[1]
            strides = args[2] if len(args) > 2 and args[2] else window
            pad = args[3] if len(args) > 3 else (0, 0)
            dil = args[4] if len(args) > 4 else (1, 1)
            ceil = args[5] if len(args) > 5 else False
            if ceil or any(d != 1 for d in dil):
                raise NotImplementedError("ceil-mode or dilated pool")
            pad = tuple(pad) * (2 // len(pad))
            out_shape = tuple(int(s) for s in node.meta["val"][0].shape)
            y = b.emit({
                "op": "maxpool", "in": x.idx,
                "window": tuple(int(w) for w in window) * (2 // len(window)),
                "strides": tuple(int(s) for s in strides)
                * (2 // len(strides)),
                # every dim's (lo, hi), NCHW, as the JAX record keeps
                # every dim's
                "padding": ((0, 0), (0, 0))
                + tuple((int(p), int(p)) for p in pad),
            }, out_shape)
            return (y, None)

        if target == aten.relu.default:
            return b.emit({"op": "act", "kind": "relu", "in": args[0].idx},
                          shape)
        if target == aten.hardtanh.default:
            lo = args[1] if len(args) > 1 else -1.0
            hi = args[2] if len(args) > 2 else 1.0
            if (lo, hi) != (0.0, 6.0):
                raise NotImplementedError(f"hardtanh({lo}, {hi})")
            return b.emit({"op": "act", "kind": "relu6",
                           "in": args[0].idx}, shape)
        if target == aten.clamp.default:
            lo = args[1] if len(args) > 1 else kwargs.get("min")
            hi = args[2] if len(args) > 2 else kwargs.get("max")
            kind = {(0, None): "relu", (0, 6): "relu6"}.get(
                (lo, hi) if lo is None else (float(lo), hi if hi is None
                                             else float(hi)))
            if kind is None:
                raise NotImplementedError(f"clamp({lo}, {hi})")
            return b.emit({"op": "act", "kind": kind, "in": args[0].idx},
                          shape)

        if target in (aten.mul.Tensor,):
            x, gate = args[:2]
            for u, g in ((x, gate), (gate, x)):
                if isinstance(u, _Sym) and isinstance(g, _Sym):
                    prod = b.producer(g.idx)
                    if (prod is not None and prod.get("op") == "ew"
                            and prod.get("fn") == "logistic"
                            and prod["args"] == [("t", u.idx)]):
                        # x * sigmoid(x): the swish idiom
                        return b.emit({"op": "act", "kind": "swish",
                                       "in": u.idx}, shape)

        if target in _EW_BINARY:
            a, c = args[:2]
            alpha = kwargs.get("alpha", 1)
            if alpha != 1:
                c = c * alpha if not isinstance(c, _Sym) else None
                if c is None:
                    raise NotImplementedError("add/sub with alpha on a "
                                              "tensor operand")
            return b.emit({"op": "ew", "fn": _EW_BINARY[target],
                           "args": [_ref(a), _ref(c)]}, shape)
        if target in _EW_UNARY:
            return b.emit({"op": "ew", "fn": _EW_UNARY[target],
                           "args": [_ref(args[0])]}, shape)

        if target == aten._native_batch_norm_legit_no_training.default:
            x, w, bias, mean, var, _, eps = args
            # the eval BatchNorm unfolded, as Flax's: (x - mean) *
            # (scale * rsqrt(var + eps)) + bias
            view = (1, -1) + (1,) * (len(x.shape) - 2)
            mul = torch.rsqrt(var.float() + eps)
            if w is not None:
                mul = mul * w.float()
            y = b.emit({"op": "ew", "fn": "sub", "args": [
                ("t", x.idx), _ref(mean.float().reshape(view))]}, x.shape)
            y = b.emit({"op": "ew", "fn": "mul", "args": [
                ("t", y.idx), _ref(mul.reshape(view))]}, x.shape)
            if bias is not None:
                y = b.emit({"op": "ew", "fn": "add", "args": [
                    ("t", y.idx), _ref(bias.float().reshape(view))]},
                    x.shape)
            return (y, None, None)

        if target in (aten.sum.dim_IntList, aten.amax.default,
                      aten.amin.default, aten.mean.dim):
            x = args[0]
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            keep = args[2] if len(args) > 2 else kwargs.get("keepdim",
                                                            False)
            axes = _batch_free(str(target), dims, len(x.shape))
            fn = {aten.sum.dim_IntList: "sum", aten.amax.default: "max",
                  aten.amin.default: "min", aten.mean.dim: "mean"}[target]
            return b.emit({"op": "reduce", "fn": fn, "in": x.idx,
                           "axes": axes, "keepdims": bool(keep)}, shape)

        if target in (aten.view.default, aten.unsqueeze.default,
                      aten.squeeze.dims, aten.squeeze.dim):
            x = args[0]
            if shape[0] != x.shape[0]:
                raise NotImplementedError(
                    f"reshape changes the batch dimension ({x.shape} -> "
                    f"{shape})")
            return b.emit({"op": "reshape", "in": x.idx,
                           "tail": shape[1:]}, shape)

        if target == aten.expand.default:
            x = args[0]
            if shape[0] != x.shape[0] or len(shape) != len(x.shape):
                raise NotImplementedError(
                    f"expand {x.shape} -> {shape} does not keep the batch")
            return b.emit({"op": "broadcast", "in": x.idx,
                           "tail": shape[1:]}, shape)

        if target == aten.permute.default:
            x, perm = args
            perm = tuple(int(p) % len(x.shape) for p in perm)
            if perm[0] != 0:
                raise NotImplementedError(
                    f"transpose moves the batch dim ({perm})")
            return b.emit({"op": "transpose", "in": x.idx, "perm": perm},
                          shape)

        if target == aten.constant_pad_nd.default:
            x, pad = args[0], args[1]
            value = float(args[2]) if len(args) > 2 else 0.0
            # ATen's pad list runs from the last dim: (lo, hi) pairs
            pairs = [(int(pad[i]), int(pad[i + 1]))
                     for i in range(0, len(pad), 2)]
            config = [(0, 0)] * (len(x.shape) - len(pairs)) + pairs[::-1]
            if config[0] != (0, 0):
                raise NotImplementedError(f"pad touches the batch: {pad}")
            return b.emit({"op": "pad", "in": x.idx,
                           "config": tuple(config[1:]), "value": value},
                          shape)

        if target == aten._log_softmax.default:
            x, axis = args[0], int(args[1]) % len(args[0].shape)
            if axis == 0:
                raise NotImplementedError("log_softmax over the batch")
            return b.emit({"op": "log_softmax", "in": x.idx, "axis": axis},
                          shape)

        raise NotImplementedError(
            f"quantization capture: ATen op {target} on an input-dependent "
            "tensor is not supported; add a handler to "
            "serve/trace._Walker.sym")


def _flatten(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from _flatten(x)
        else:
            yield x


class _EvalForward(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x, train=False)


def trace_graph(model_cfg, state_dict) -> Graph:
    """Capture the model's eval forward as the quantization graph IR.

    The model is rebuilt on the CPU with ``compute_dtype=float32``, the
    stock pool and no remat, so the captured math is the canonical
    conv + ReLU + pool form (the fused pools are the same function)."""
    from skin_image_analysis_tpu_torch.models.cnn import build_model

    if getattr(model_cfg, "in_channels", 3) != 3:
        raise ValueError("int8 quantization expects RGB-input models")
    cfg = replace(model_cfg, compute_dtype="float32", fused_pool=False,
                  pool_mode="stock", remat=False)
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: v.detach().cpu() for k, v in
                           state_dict.items()})
    model.eval()
    size = int(model_cfg.image_size)
    spec = torch.zeros((1, size, size, 3), dtype=torch.float32)
    with torch.no_grad():
        ep = torch.export.export(_EvalForward(model), (spec,))
    walker = _Walker(ep.run_decompositions())
    out = walker.run()
    return Graph(ops=walker.b.ops, out=out.idx)


# -- float executor (calibration pass + fidelity oracle) --------------------


def _pad_nchw(x: torch.Tensor, padding, value: float) -> torch.Tensor:
    """Pad the trailing spatial dims by ``((lo, hi), (lo, hi))``."""
    flat = []
    for lo, hi in reversed(padding):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def conv2d(x: torch.Tensor, kernel: torch.Tensor, op: dict) -> torch.Tensor:
    """The captured conv on ``x`` (NCHW) with ``kernel`` (OIHW)."""
    (t, bo), (lft, r) = op["padding"]
    if t == bo and lft == r:
        return F.conv2d(x, kernel, None, op["strides"], (t, lft),
                        groups=op["groups"])
    return F.conv2d(_pad_nchw(x, op["padding"], 0.0), kernel, None,
                    op["strides"], groups=op["groups"])


def maxpool(x: torch.Tensor, op: dict) -> torch.Tensor:
    (t, bo), (lft, r) = op["padding"][2:]
    if t != bo or lft != r:
        x = _pad_nchw(x, op["padding"][2:], float("-inf"))
        t = lft = 0
    return F.max_pool2d(x, op["window"], op["strides"], (t, lft))


def _arg(tag, v, get, device):
    return get(v) if tag == "t" else v.to(device)


def run_op_float(op: dict, get, device) -> torch.Tensor:
    """Replay one captured op in float32; ``get(idx)`` returns tensor
    ``idx`` in float32 (the int8 executor passes a dequantizing getter
    for the ops it replays in float)."""
    kind = op["op"]
    if kind == "conv":
        return conv2d(get(op["in"]), op["kernel"].to(device), op)
    if kind == "dense":
        return get(op["in"]) @ op["kernel"].to(device)
    if kind == "maxpool":
        return maxpool(get(op["in"]), op)
    if kind == "act":
        return ACTIVATIONS[op["kind"]](get(op["in"]))
    if kind == "ew":
        vals = [_arg(tag, v, get, device) for tag, v in op["args"]]
        if op["fn"] == "convert":
            return vals[0].to(getattr(torch, op["dtype"])).float()
        if len(vals) == 1:
            return _UNARY_FNS[op["fn"]](vals[0])
        return _BINARY_FNS[op["fn"]](vals[0], vals[1])
    if kind == "reduce":
        x = get(op["in"])
        if op["fn"] == "sum":
            return x.sum(dim=op["axes"], keepdim=op["keepdims"])
        if op["fn"] == "mean":
            return x.mean(dim=op["axes"], keepdim=op["keepdims"])
        fn = torch.amax if op["fn"] == "max" else torch.amin
        return fn(x, dim=op["axes"], keepdim=op["keepdims"])
    if kind == "reshape":
        x = get(op["in"])
        return x.reshape((x.shape[0],) + tuple(op["tail"]))
    if kind == "broadcast":
        x = get(op["in"])
        return x.expand((x.shape[0],) + tuple(op["tail"]))
    if kind == "transpose":
        return get(op["in"]).permute(op["perm"])
    if kind == "squeeze":
        return get(op["in"]).squeeze(op["dims"])
    if kind == "pad":
        x = get(op["in"])
        flat = []
        for lo, hi in reversed(op["config"]):
            flat += [lo, hi]
        return F.pad(x, flat, value=op["value"])
    if kind == "log_softmax":
        return F.log_softmax(get(op["in"]), dim=op["axis"])
    raise ValueError(f"unknown op {kind!r}")  # pragma: no cover


def last_uses(graph: Graph) -> list[int]:
    """For each tensor, the index of the last op that reads it (-1 for
    none); the graph's output is read after every op."""
    n_t = len(graph.ops) + 1
    last = [-1] * n_t
    for i, op in enumerate(graph.ops):
        for t in op_inputs(op):
            last[t] = i
    last[graph.out] = len(graph.ops)
    return last


def op_inputs(op: dict) -> list[int]:
    if op["op"] == "ew":
        return [v for tag, v in op["args"] if tag == "t"]
    return [op["in"]]


def abs_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of |x| over all elements, linear interpolation
    between the two nearest order statistics in float32, as
    ``jnp.quantile`` computes it."""
    v = torch.sort(x.detach().abs().float().reshape(-1)).values
    n = v.numel()
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    return (v[int(lo.clamp(0, n - 1))] * (1 - w_hi)
            + v[int(hi.clamp(0, n - 1))] * w_hi)


def graph_forward(graph: Graph, x: torch.Tensor, taps: bool = False,
                  tap_quantile: float | None = None):
    """Replay the captured graph in float32: the calibration pass and
    the fidelity oracle. ``taps=True`` also returns a ``[n_tensors]``
    statistic of |x| for every tensor: its max, or its ``tap_quantile``
    quantile (percentile calibration: outliers saturate at +-127 instead
    of stretching every scale). A tensor is freed once its last reader
    has run."""
    device = x.device
    last = last_uses(graph)
    ts: dict[int, torch.Tensor] = {0: x.float()}
    stats = []

    def stat(t):
        if tap_quantile is None:
            return t.detach().abs().amax().float()
        return abs_quantile(t, float(tap_quantile))

    if taps:
        stats.append(stat(ts[0]))
    for i, op in enumerate(graph.ops):
        y = run_op_float(op, ts.__getitem__, device)
        ts[i + 1] = y
        if taps:
            stats.append(stat(y))
        for t in op_inputs(op):
            if last[t] == i and t != graph.out:
                ts.pop(t, None)
    out = ts[graph.out]
    if not taps:
        return out
    return out, torch.stack(stats)


# -- the trace file ----------------------------------------------------------


def _record_value(v):
    if isinstance(v, torch.Tensor):
        return {"shape": list(v.shape), "dtype": str(v.dtype).replace(
            "torch.", "")}
    if isinstance(v, (list, tuple)):
        return [_record_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _record_value(x) for k, x in v.items()}
    return v


def graph_records(ops: list[dict]) -> list[dict]:
    """The IR (float or quantized) as JSON-ready records: one per op,
    with ``index`` (the tensor it makes) first and every array given by
    its shape and dtype."""
    return [{"index": i + 1, **{k: _record_value(v) for k, v in op.items()}}
            for i, op in enumerate(ops)]


def write_graph_jsonl(ops: list[dict], path: str) -> int:
    """Write :func:`graph_records` to ``path`` as JSON lines; returns the
    number of records."""
    records = graph_records(ops)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return len(records)

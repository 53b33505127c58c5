"""Post-training int8 quantization of the inference program (port of the
JAX package's ``serve.quantize``).

Scheme (symmetric PTQ, the JAX module's):

- **Weights**: per-output-channel symmetric int8, ``w_q = clip(round(w /
  s_w), -127, 127)`` with ``s_w[o] = max|w[o]| / 127`` (round half to
  even, as ``np.rint``). No zero-point, so zero padding stays exact, and
  BatchNorm needs no folding (it rides as float32 epilogue ops).
- **Activations**: per-tensor symmetric int8 with max calibration,
  ``s_x = max|x| / 127`` over the calibration rows at every tensor of the
  captured graph (``serve.trace``), or a percentile of |x| with
  ``calib_mode="percentile[:p]"``.
- **Where int8 is stored and where it is simulated.** As in the JAX
  module, the int8 weights (``kernel_q``) are stored int8, and every
  activation that feeds a quantized contraction through max-pools and
  reshapes is stored int8 at its own scale; bias, BatchNorm, residual
  adds, squeeze-excite internals and the log-softmax stay float32. Where
  the JAX module contracts ``s8 x s8 -> s32``, the port contracts the
  same int8 values held in float32 (a float32 conv or matmul; TF32, where
  allowed, also holds 8-bit integers exactly): int8 values and their
  products are exact and the sum accumulates in float32, which equals the
  int32 sum while it stays below 2**24. The result is dequantized by ``s_x * s_w[o]`` as
  the JAX module's is. Max-pools of int8 tensors run on their float32
  copies and store int8 again (max commutes with the quantizer).

:func:`quantize_weights_only` is the weight-only scheme for any family:
int8 weights with per-output-channel scales (axis 0 of a PyTorch weight,
the JAX module's last kernel axis), dequantized in the program's
prologue. :func:`quantization_report` and :func:`weights_only_report`
compare a quantized program with the float one on held-out pixels, with
the JAX module's keys.

``torch.ao.quantization`` is not used: the programs are plain modules
with int8 buffers, which ``torch.export`` saves as they are.
"""

from __future__ import annotations

import os
import warnings
from typing import Any

import numpy as np
import torch
from torch import nn

from skin_image_analysis_tpu_torch.ops.preprocess import (
    normalize_affine,
    preprocess_batch,
)
from skin_image_analysis_tpu_torch.serve.trace import (
    ACTIVATIONS,
    Graph,
    conv2d,
    graph_forward,
    last_uses,
    maxpool,
    op_inputs,
    run_op_float,
    trace_graph,
)

#: captured ops that pass int8 values through exactly
_PASSTHROUGH = ("maxpool", "reshape")
#: calibration rows a float forward runs at once in max mode (the max of
#: the chunks' maxima is the max over all rows)
CALIB_CHUNK = 32


def _per_channel_int8(w: torch.Tensor, out_axis: int):
    """``(w_q int8, s_w float64 per output channel)`` of a weight whose
    output channels run along ``out_axis``."""
    w64 = w.detach().cpu().double()
    axes = tuple(a for a in range(w64.dim()) if a != out_axis % w64.dim())
    s = torch.clamp(w64.abs().amax(dim=axes), min=1e-12) / 127.0
    view = [1] * w64.dim()
    view[out_axis] = -1
    q = torch.clamp(torch.round(w64 / s.reshape(view)), -127, 127)
    return q.to(torch.int8), s


def _quantize_ops(graph: Graph, scales: list[float]) -> list[dict]:
    """Captured float graph + per-tensor activation scales -> the int8 op
    list (int8 kernels, dequant vectors, requantize points), placed as
    the JAX module places them: a quantized contraction reads int8 (the
    scale its input carries, or a fresh quantization at the input's
    calibrated scale); an activation stores int8 at its own scale iff it
    feeds a quantized contraction through max-pools and reshapes; pools
    and reshapes carry their input's representation."""
    ops = graph.ops
    n_t = len(ops) + 1
    feeds_q = [False] * n_t
    for i in reversed(range(len(ops))):
        op = ops[i]
        if op["op"] in ("conv", "dense") and op.get("quantize"):
            feeds_q[op["in"]] = True
        elif op["op"] in _PASSTHROUGH and feeds_q[i + 1]:
            feeds_q[op["in"]] = True

    eff: list = [None] * n_t
    qops: list[dict] = []
    for i, op in enumerate(ops):
        out = i + 1
        kind = op["op"]
        q = {k: v for k, v in op.items() if k != "kernel"}
        if kind in ("conv", "dense"):
            if op.get("quantize"):
                # conv OIHW: output channels on axis 0; dense [in, out]
                axis = 0 if kind == "conv" else -1
                kq, s_w = _per_channel_int8(op["kernel"], axis)
                q["kernel_q"] = kq
                s_in = eff[op["in"]]
                if s_in is None:
                    s_in = scales[op["in"]]
                q["in_scale"] = float(s_in)
                deq = (s_in * s_w).float()
                q["dequant"] = deq.reshape(1, -1, 1, 1) if kind == "conv" \
                    else deq
            else:
                q["kernel"] = op["kernel"]
            eff[out] = None
        elif kind == "act":
            q["out_scale"] = scales[out] if feeds_q[out] else None
            eff[out] = q["out_scale"]
        elif kind in _PASSTHROUGH:
            eff[out] = eff[op["in"]]
        else:
            eff[out] = None
        qops.append(q)
    return qops


def _quant(v: torch.Tensor, s: float) -> torch.Tensor:
    return torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)


def quantized_forward(qtree: dict, x01: torch.Tensor,
                      consts: dict | None = None) -> torch.Tensor:
    """``[B, S, S, 3]`` preprocessed floats -> float32 log-probs through
    the int8 op list. ``consts`` maps ``(op index, key)`` to the op's
    tensors on the right device (a :class:`QuantizedProgram`'s buffers);
    without it the tree's own tensors move to ``x01``'s device."""
    device = x01.device

    def c(i, key, v):
        if consts is not None and (i, key) in consts:
            return consts[(i, key)]
        return v.to(device)

    ops = qtree["ops"]
    last = last_uses(Graph(ops=ops, out=qtree["out"]))
    # tensors: (tensor, scale); scale None marks a float32 tensor
    ts: dict[int, tuple] = {0: (x01.float(), None)}

    def get_f32(t):
        a, s = ts[t]
        return a if s is None else a.float() * s

    for i, op in enumerate(ops):
        kind = op["op"]
        if kind in ("conv", "dense") and op.get("quantize"):
            a, s = ts[op["in"]]
            if s is None:
                a = _quant(a, op["in_scale"])
            kq = c(i, "kernel_q", op["kernel_q"])
            # int8 values contract exactly in float32 (see the module
            # docstring); the float result is the int32 sum
            if kind == "conv":
                y = conv2d(a.float(), kq.float(), op)
            else:
                y = a.float() @ kq.float()
            y = (y * c(i, "dequant", op["dequant"]), None)
        elif kind == "act":
            v = ACTIVATIONS[op["kind"]](get_f32(op["in"]))
            s = op["out_scale"]
            y = (_quant(v, s), s) if s is not None else (v, None)
        elif kind == "maxpool":
            a, s = ts[op["in"]]
            p = maxpool(a.float(), op)
            y = (p.to(torch.int8), s) if s is not None else (p, None)
        elif kind == "reshape":
            a, s = ts[op["in"]]
            y = (a.reshape((a.shape[0],) + tuple(op["tail"])), s)
        else:
            # bias/BN epilogues, residual adds, GAP, SE gates and the
            # log-softmax replay in float32
            op_c = op
            if kind == "ew":
                op_c = {**op, "args": [
                    (tag, c(i, f"arg{j}", v) if tag == "c" else v)
                    for j, (tag, v) in enumerate(op["args"])]}
            elif kind == "conv" or kind == "dense":
                op_c = {**op, "kernel": c(i, "kernel", op["kernel"])}
            y = (run_op_float(op_c, get_f32, device), None)
        ts[i + 1] = y
        for t in op_inputs(op):
            if last[t] == i and t != qtree["out"]:
                ts.pop(t, None)
    return get_f32(qtree["out"])


# -- public API ---------------------------------------------------------------


def _eval_preprocess(image_size: int, normalize_imagenet: bool,
                     input_affine):
    def pre(pixels: torch.Tensor) -> torch.Tensor:
        return preprocess_batch(
            pixels, None, image_size=image_size, train=False,
            normalize_imagenet=normalize_imagenet, input_affine=input_affine)

    return pre


def parse_calib_mode(mode: str) -> float | None:
    """``"max"`` -> None; ``"percentile"`` / ``"percentile:99.9"`` -> the
    quantile in [0, 1]. Raises on anything else."""
    if mode == "max":
        return None
    if mode == "percentile" or mode.startswith("percentile:"):
        p = 99.9 if mode == "percentile" else float(mode.split(":", 1)[1])
        if not 50.0 < p <= 100.0:
            raise ValueError(f"percentile must be in (50, 100], got {p}")
        return p / 100.0
    raise ValueError(
        f"unknown calibration mode {mode!r} (max | percentile[:p])")


def _device(device) -> torch.device:
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    return resolve_device(device)


def _as_device_pixels(pixels, device) -> torch.Tensor:
    if isinstance(pixels, torch.Tensor):
        return pixels.to(device)
    return torch.from_numpy(np.ascontiguousarray(pixels, np.uint8)).to(
        device)


@torch.no_grad()
def quantize_model(model_cfg, state_dict, calib_pixels,
                   normalize_imagenet: bool = False, input_affine=None,
                   calib_mode: str = "max", device="cuda",
                   graph: Graph | None = None) -> dict[str, Any]:
    """Build the int8 model from a float checkpoint.

    ``calib_pixels``: uint8 ``[n, H, W, 3]`` calibration images; they run
    through the serving program's eval preprocess, so the activation
    scales match deployment. ``calib_mode``: ``"max"`` (each tensor's
    observed max|x|) or ``"percentile[:p]"`` (the p-th percentile of |x|,
    default 99.9, over all calibration rows at once). The calibration
    forward runs on ``device``; in max mode it takes
    :data:`CALIB_CHUNK` rows at a time. ``graph`` is the checkpoint's
    capture when the caller has one (``trace_graph``). Returns the
    quantized tree: the int8 op list plus the per-tensor activation
    scales."""
    tap_q = parse_calib_mode(calib_mode)
    device = _device(device)
    graph = graph or trace_graph(model_cfg, state_dict)
    affine = normalize_affine(input_affine)
    pre = _eval_preprocess(model_cfg.image_size, normalize_imagenet, affine)
    px = _as_device_pixels(calib_pixels, device)
    if tap_q is None:
        maxima = None
        for i in range(0, px.shape[0], CALIB_CHUNK):
            _, m = graph_forward(graph, pre(px[i:i + CALIB_CHUNK]),
                                 taps=True)
            maxima = m if maxima is None else torch.maximum(maxima, m)
    else:
        _, maxima = graph_forward(graph, pre(px), taps=True,
                                  tap_quantile=tap_q)
    scales = [max(float(m), 1e-12) / 127.0 for m in maxima.cpu()]
    return {
        "ops": _quantize_ops(graph, scales),
        "out": graph.out,
        "scales": scales,
        "model": model_cfg.name,
        "image_size": int(model_cfg.image_size),
        "num_classes": int(model_cfg.num_classes),
        "normalize_imagenet": bool(normalize_imagenet),
        "input_affine": affine,
        "calib_mode": calib_mode,
    }


class QuantizedProgram(nn.Module):
    """The quantized serving program: uint8 NHWC pixels -> the eval
    preprocess the tree was calibrated with -> the int8 forward ->
    ``{log_probs, pred, p_malignant}`` (the contract of
    ``serve.export.InferenceProgram``). The int8 kernels, dequant vectors
    and float constants are buffers, so ``.to(device)`` moves them and
    ``torch.export`` saves them as they are."""

    def __init__(self, qtree: dict, malignant_index: int = 1):
        super().__init__()
        self.qtree = qtree
        self.malignant_index = int(malignant_index)
        self.image_size = int(qtree["image_size"])
        self.pre = _eval_preprocess(
            self.image_size, qtree.get("normalize_imagenet", False),
            qtree.get("input_affine"))
        self._names: dict[tuple, str] = {}
        for i, op in enumerate(qtree["ops"]):
            tensors = {k: op[k] for k in ("kernel_q", "dequant", "kernel")
                       if isinstance(op.get(k), torch.Tensor)}
            if op["op"] == "ew":
                tensors.update({f"arg{j}": v for j, (tag, v) in
                                enumerate(op["args"]) if tag == "c"})
            for key, v in tensors.items():
                name = f"op{i}_{key}"
                self.register_buffer(name, v.detach().clone())
                self._names[(i, key)] = name

    def forward(self, pixels: torch.Tensor) -> dict[str, torch.Tensor]:
        consts = {k: getattr(self, n) for k, n in self._names.items()}
        log_probs = quantized_forward(self.qtree, self.pre(pixels), consts)
        return {
            "log_probs": log_probs,
            "pred": log_probs.argmax(dim=-1),
            "p_malignant": log_probs[:, self.malignant_index].exp(),
        }


def build_infer_fn_quantized(qtree: dict, malignant_index: int = 1,
                             device="cuda") -> QuantizedProgram:
    """The quantized serving program on ``device``."""
    return QuantizedProgram(qtree, malignant_index).to(
        _device(device)).eval()


@torch.no_grad()
def quantization_report(model_cfg, state_dict, qtree, eval_pixels,
                        device="cuda", graph: Graph | None = None
                        ) -> dict[str, float]:
    """Fidelity of the int8 program vs the float graph on held-out
    pixels: argmax agreement (overall, and on rows where the float model
    is confident: top margin > 0.5 nat), plus the mean |dlog p|.
    ``graph`` as for :func:`quantize_model`."""
    device = _device(device)
    graph = graph or trace_graph(model_cfg, state_dict)
    pre = _eval_preprocess(qtree["image_size"],
                           qtree.get("normalize_imagenet", False),
                           qtree.get("input_affine"))
    prog = build_infer_fn_quantized(qtree, device=device)
    px = _as_device_pixels(eval_pixels, device)
    refs, gots = [], []
    for i in range(0, px.shape[0], CALIB_CHUNK):
        x = pre(px[i:i + CALIB_CHUNK]).float()
        refs.append(graph_forward(graph, x).cpu())
        consts = {k: getattr(prog, n) for k, n in prog._names.items()}
        gots.append(quantized_forward(qtree, x, consts).cpu())
    return _fidelity(torch.cat(refs).numpy(), torch.cat(gots).numpy())


# -- weight-only int8 (any family) -------------------------------------------


def quantize_weights_only(state_dict: dict[str, torch.Tensor]) -> dict:
    """Per-output-channel symmetric int8 on every weight of two or more
    dims (output channels on axis 0, PyTorch's layout), every other
    tensor float32 (integer buffers as they are). A quantized entry is
    ``{"_w8": int8, "_scale": float32 [out]}``."""
    out: dict[str, Any] = {}
    for name, v in state_dict.items():
        v = v.detach().cpu()
        if not v.is_floating_point():
            out[name] = v.clone()
        elif v.dim() < 2:
            out[name] = v.float().clone()
        else:
            q, s = _per_channel_int8(v, 0)
            out[name] = {"_w8": q, "_scale": s.float()}
    return out


def dequantize_weights(qparams: dict) -> dict[str, torch.Tensor]:
    """The inverse of :func:`quantize_weights_only`: each ``{"_w8",
    "_scale"}`` entry as its float32 weight (``w8 * scale`` per output
    channel), every other entry as it is; :class:`WeightOnlyProgram`
    runs it in the prologue of each call."""
    out: dict[str, torch.Tensor] = {}
    for name, v in qparams.items():
        if isinstance(v, dict):
            scale = v["_scale"].float()
            out[name] = v["_w8"].float() * scale.reshape(
                -1, *([1] * (v["_w8"].dim() - 1)))
        else:
            out[name] = v
    return out


class WeightOnlyProgram(nn.Module):
    """``serve.export.InferenceProgram`` whose weights are int8 buffers
    with float32 scales, dequantized to the parameter dtype in the
    prologue of every call (the model computes as before)."""

    def __init__(self, program: nn.Module, qparams: dict):
        super().__init__()
        self.program = program
        self._plain: dict[str, str] = {}
        self._quant: dict[str, tuple[str, str]] = {}
        ref = program.model.state_dict()
        self._dtypes = {k: v.dtype for k, v in ref.items()}
        for i, (name, v) in enumerate(qparams.items()):
            if isinstance(v, dict):
                self.register_buffer(f"w8_{i}", v["_w8"].clone())
                self.register_buffer(f"scale_{i}", v["_scale"].clone())
                self._quant[name] = (f"w8_{i}", f"scale_{i}")
            else:
                self.register_buffer(f"t_{i}", v.clone())
                self._plain[name] = f"t_{i}"
        # the float copies go: the int8 buffers are the weights that ship
        for p in program.model.parameters():
            p.requires_grad_(False)
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def weights(self) -> dict[str, torch.Tensor]:
        qparams = {name: {"_w8": getattr(self, w8),
                          "_scale": getattr(self, sc)}
                   for name, (w8, sc) in self._quant.items()}
        qparams.update((name, getattr(self, t))
                       for name, t in self._plain.items())
        return {name: v.to(self._dtypes[name]) if v.is_floating_point()
                else v for name, v in dequantize_weights(qparams).items()}

    def forward(self, pixels: torch.Tensor) -> dict[str, torch.Tensor]:
        return torch.func.functional_call(self.program, {
            f"model.{k}": v for k, v in self.weights().items()}, (pixels,))


def build_infer_fn_w8(model_cfg, qparams: dict,
                      malignant_index: int = 1,
                      normalize_imagenet: bool = False, input_affine=None,
                      device="cuda") -> WeightOnlyProgram:
    """The weight-only-quantized serving program on ``device``: the
    float program of ``model_cfg`` with int8 weights."""
    from skin_image_analysis_tpu_torch.serve.export import (
        build_infer_fn_weights_arg,
    )

    inner = build_infer_fn_weights_arg(
        model_cfg, malignant_index=malignant_index,
        normalize_imagenet=normalize_imagenet, input_affine=input_affine,
        device=device)
    return WeightOnlyProgram(inner, qparams).to(device).eval()


@torch.no_grad()
def weights_only_report(model_cfg, state_dict, qparams, eval_pixels,
                        normalize_imagenet: bool = False,
                        input_affine=None, device="cuda") -> dict[str, float]:
    """Fidelity of the weight-only program vs the float one on held-out
    pixels (the keys of :func:`quantization_report`)."""
    from skin_image_analysis_tpu_torch.serve.export import build_infer_fn

    device = _device(device)
    ref_fn = build_infer_fn(model_cfg, state_dict,
                            normalize_imagenet=normalize_imagenet,
                            input_affine=input_affine, device=device)
    got_fn = build_infer_fn_w8(model_cfg, qparams,
                               normalize_imagenet=normalize_imagenet,
                               input_affine=input_affine, device=device)
    px = _as_device_pixels(eval_pixels, device)
    refs, gots = [], []
    for i in range(0, px.shape[0], CALIB_CHUNK):
        refs.append(ref_fn(px[i:i + CALIB_CHUNK])["log_probs"].cpu())
        gots.append(got_fn(px[i:i + CALIB_CHUNK])["log_probs"].cpu())
    return _fidelity(torch.cat(refs).numpy(), torch.cat(gots).numpy())


def _fidelity(ref: np.ndarray, got: np.ndarray) -> dict[str, float]:
    pred_ref, pred_q = ref.argmax(-1), got.argmax(-1)
    sorted_ref = np.sort(ref, axis=-1)
    margin = sorted_ref[:, -1] - sorted_ref[:, -2]
    confident = margin > 0.5
    agree = float((pred_ref == pred_q).mean())
    agree_conf = (
        float((pred_ref[confident] == pred_q[confident]).mean())
        if confident.any() else 1.0
    )
    return {
        "agreement": agree,
        "agreement_confident": agree_conf,
        "confident_fraction": float(confident.mean()),
        "mean_abs_dlogp": float(np.abs(ref - got).mean()),
        "n": int(len(pred_ref)),
    }


def calibration_rows(folder: str, root: str, n_rows: int = 256,
                     report_only: bool = False):
    """Calibration pixels from an experiment's train split (falling back
    to the test split) and held-out report pixels from the test split,
    uint8 NHWC at the model's size.

    Returns ``(calib, report, report_is_calib)``: ``report_is_calib`` is
    True when the train split was absent and calibration fell back to the
    test rows, so the fidelity report scores the calibration rows
    themselves (optimistic; the manifest says so). ``report`` is None
    without a ``session_test.csv``; ``report_only`` skips the train
    split."""
    from skin_image_analysis_tpu_torch.data.dataset import LesionTable
    from skin_image_analysis_tpu_torch.data.ingest import read_csv
    from skin_image_analysis_tpu_torch.data.loader import HostImageStore
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib

    model_cfg, _ = ckpt_lib.load_model(
        os.path.join(folder, ckpt_lib.MODEL_FILENAME))

    def rows(csv_name: str):
        path = os.path.join(folder, csv_name)
        if not os.path.exists(path):
            return None
        df = read_csv(path, index_col=True)
        df = df.take(range(min(n_rows, len(df))))
        # only the pixels matter: a fabricated label column lets transfer
        # folders (tone_label / HAM dx splits) decode the same way
        df = df.with_column("benign_malignant", ["benign"] * len(df))
        store = HostImageStore(LesionTable(df, root),
                               canonical_size=model_cfg.image_size)
        return np.ascontiguousarray(store.images.transpose(0, 2, 3, 1))

    report = rows("session_test.csv")
    if report_only:
        return None, report, False
    calib = rows("session_train.csv")
    report_is_calib = False
    if calib is None:
        calib = report
        report_is_calib = calib is not None
        if report_is_calib:
            warnings.warn(
                f"{folder} has no session_train.csv: calibrating on the "
                "TEST split; the fidelity report will score the "
                "calibration rows themselves (optimistic; the manifest "
                "marks report_on_calibration_rows)", stacklevel=2)
    if calib is None:
        raise ValueError(
            f"{folder} has no session_train.csv/session_test.csv to "
            "calibrate from")
    return calib, report, report_is_calib

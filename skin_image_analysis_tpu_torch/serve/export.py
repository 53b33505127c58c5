"""The inference program, and its export as a ``torch.export`` artifact
(port of the JAX package's ``serve.export``).

The program is the whole serving call: uint8 ``[b, S, S, 3]`` pixels ->
the eval preprocess (resize to the model's size, /255, the folder's
ImageNet normalization or input affine, or the ITA channels of an
``in_channels=2`` model) -> the forward -> ``{log_probs, pred,
p_malignant}``. :func:`export_model` traces it with a dynamic batch
dimension and saves it with ``torch.export.save``: one file that holds the
weights and the graph, served by ``torch.export.load`` without the
model's Python classes. A JSON manifest beside it (``out_path + ".json"``)
carries the class names, the input spec and the batch range, so a client
can check its inputs without loading the program.

An artifact runs on the device it was exported on: the manifest's
``platforms`` names it, and it is checked there before it is written.
``quantize="int8"`` exports the post-training-quantized program of
``serve.quantize`` (int8 weights and activations), ``"int8-weights"``
the float program with int8 weights dequantized in its prologue; the
manifest's ``quantization`` carries the scheme, the calibration mode and
the fidelity report, with the JAX package's keys.
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.data.ita import ita_input
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.ops.preprocess import (
    normalize_affine,
    preprocess_batch,
)
from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib
from skin_image_analysis_tpu_torch.train.loop import resolve_device

MANIFEST_SUFFIX = ".json"
#: the batch an export falls back to when the dynamic batch fails to trace
FIXED_BATCH = 64
#: the largest batch of a dynamic-batch artifact
MAX_BATCH = 1024


class InferenceProgram(nn.Module):
    """``program(pixels) -> {log_probs, pred, p_malignant}`` for uint8
    NHWC pixels of any square size (resized to the model's). The model is
    in eval mode; call it under ``torch.inference_mode()``."""

    def __init__(self, model: nn.Module, image_size: int,
                 malignant_index: int = 1, normalize_imagenet: bool = False,
                 input_affine: tuple | None = None, ita: bool = False):
        super().__init__()
        self.model = model.eval()
        self.image_size = int(image_size)
        self.malignant_index = int(malignant_index)
        # ITA-input models take [ITA/90, skin mask] of the raw [0, 1] RGB:
        # no ImageNet normalization or affine applies there
        self.ita = bool(ita)
        self.normalize_imagenet = bool(normalize_imagenet) and not ita
        self.input_affine = None if ita else normalize_affine(input_affine)

    def forward(self, pixels: torch.Tensor) -> dict[str, torch.Tensor]:
        x = preprocess_batch(
            pixels, None, image_size=self.image_size, train=False,
            normalize_imagenet=self.normalize_imagenet,
            input_affine=self.input_affine)
        if self.ita:
            x = ita_input(x)
        log_probs = self.model(x, train=False).float()
        return {
            "log_probs": log_probs,
            "pred": log_probs.argmax(dim=-1),
            "p_malignant": log_probs[:, self.malignant_index].exp(),
        }


def build_infer_fn_weights_arg(model_cfg: ModelConfig,
                               malignant_index: int = 1,
                               normalize_imagenet: bool = False,
                               input_affine: tuple | None = None,
                               device="cuda") -> InferenceProgram:
    """The inference program of ``model_cfg`` on ``device``, its weights
    still to load: ``program.model.load_state_dict`` puts a checkpoint in,
    and a session hot-swaps a same-architecture checkpoint by copying into
    the same tensors (``InferenceSession.reload_weights``)."""
    dev = resolve_device(device)
    model = build_model(model_cfg, device=dev)
    return InferenceProgram(
        model, model_cfg.image_size, malignant_index, normalize_imagenet,
        input_affine, ita=getattr(model_cfg, "in_channels", 3) == 2)


def build_infer_fn(model_cfg: ModelConfig,
                   state_dict: dict[str, torch.Tensor],
                   malignant_index: int = 1,
                   normalize_imagenet: bool = False,
                   input_affine: tuple | None = None,
                   device="cuda") -> InferenceProgram:
    """:func:`build_infer_fn_weights_arg` with ``state_dict`` loaded: the
    program :func:`export_model` traces. ``normalize_imagenet`` and
    ``input_affine`` must be the training run's."""
    program = build_infer_fn_weights_arg(
        model_cfg, malignant_index, normalize_imagenet, input_affine,
        device)
    program.model.load_state_dict(state_dict)
    return program


def read_train_config(folder: str) -> dict:
    """The folder's ``train_config.json``, or ``{}`` without one."""
    cfg_path = os.path.join(folder, "train_config.json")
    if not os.path.exists(cfg_path):
        return {}
    with open(cfg_path) as f:
        return json.load(f)


def artifact_spec(ep) -> tuple[int, int, tuple[int, int]]:
    """``(size, channels, (least, most))`` of an exported program's
    input: the square side, the channels, and the rows one call takes
    (one number twice for a fixed batch)."""
    node = next(n for n in ep.graph.nodes if n.op == "placeholder"
                and n.name in ep.graph_signature.user_inputs)
    b, size, _, channels = node.meta["val"].shape
    if isinstance(b, int):
        return int(size), int(channels), (b, b)
    rng = ep.range_constraints[b.node.expr]
    return int(size), int(channels), (max(1, int(rng.lower)),
                                      min(int(rng.upper), MAX_BATCH))


def _check_exported(program: InferenceProgram, exported, size: int,
                    batch: int, device: torch.device) -> None:
    """The loaded-form module against the eager program on seeded pixels
    (the same graph: bit for bit in practice; 1e-5 allowed)."""
    rng = np.random.default_rng(0)
    pixels = torch.from_numpy(rng.integers(
        0, 256, (batch, size, size, 3), np.uint8)).to(device)
    with torch.inference_mode():
        want = program(pixels)
        got = exported(pixels)
    err = float((got["log_probs"] - want["log_probs"]).abs().max())
    if err > 1e-5 or not torch.equal(got["pred"], want["pred"]):
        raise RuntimeError(f"the exported program disagrees with the eager "
                           f"one on {device}: max |dlog_probs| {err}")


def export_model(
    experiment_folder: str,
    out_path: str,
    canonical_size: int | None = None,
    platforms: Sequence[str] | None = None,
    class_names: Sequence[str] | None = None,
    normalize_imagenet: bool | None = None,
    quantize: str | None = None,
    calib_pixels=None,
    report_pixels=None,
    model_filename: str | None = None,
    report_on_calibration_rows: bool = False,
    calib_mode: str = "max",
    device="cuda",
) -> dict:
    """Export the folder's model as a ``torch.export`` program at
    ``out_path`` and its manifest at ``out_path + ".json"``; returns the
    manifest.

    ``normalize_imagenet`` and the input affine come from the folder's
    ``train_config.json`` (``normalize_imagenet=None``; True forces it).
    The input is ``canonical_size`` square pixels (the model's size by
    default). The batch is dynamic (``"symbolic"`` in the manifest, its
    range under ``"batch_range"``) where it traces; otherwise the export
    falls back to a fixed batch of 64, says why, and the manifest records
    it. ``platforms``, if given, must name ``device``'s type only: the
    artifact runs where it was exported.

    ``quantize="int8"`` exports the int8 program (``serve.quantize``)
    calibrated on ``calib_pixels`` (uint8 NHWC, e.g. a few hundred train
    rows) with ``calib_mode``; ``"int8-weights"`` needs no calibration.
    ``report_pixels`` (held-out rows) adds the fidelity report to the
    manifest, and ``report_on_calibration_rows`` marks a report scored
    on the calibration rows themselves."""
    dev = resolve_device(device)
    if platforms and list(platforms) != [dev.type]:
        raise ValueError(
            f"platforms {list(platforms)}: a torch.export artifact runs on "
            f"the device it was exported on; export on each of them "
            f"(device={dev.type!r} here)")
    model_cfg, state_dict = ckpt_lib.load_model(os.path.join(
        experiment_folder, model_filename or ckpt_lib.MODEL_FILENAME))
    train_cfg = read_train_config(experiment_folder)
    data_cfg = train_cfg.get("data", {})
    if normalize_imagenet is None:
        normalize_imagenet = bool(data_cfg.get("normalize_imagenet", False))
    input_affine = data_cfg.get("input_affine")
    if class_names is None:
        class_names = train_cfg.get("class_names", ("benign", "malignant"))
    s = canonical_size or model_cfg.image_size
    quant_report = None
    if quantize == "int8":
        if calib_pixels is None:
            raise ValueError(
                "quantize='int8' needs calib_pixels (uint8 images, e.g. "
                "a few hundred training rows)")
        from skin_image_analysis_tpu_torch.serve.quantize import (
            build_infer_fn_quantized,
            quantization_report,
            quantize_model,
        )
        from skin_image_analysis_tpu_torch.serve.trace import trace_graph

        graph = trace_graph(model_cfg, state_dict)
        qtree = quantize_model(
            model_cfg, state_dict, calib_pixels,
            normalize_imagenet=normalize_imagenet,
            input_affine=input_affine, calib_mode=calib_mode, device=dev,
            graph=graph)
        if report_pixels is not None:
            quant_report = quantization_report(
                model_cfg, state_dict, qtree, report_pixels, device=dev,
                graph=graph)
        program = build_infer_fn_quantized(qtree, device=dev)
    elif quantize == "int8-weights":
        from skin_image_analysis_tpu_torch.serve.quantize import (
            build_infer_fn_w8,
            quantize_weights_only,
            weights_only_report,
        )

        qparams = quantize_weights_only(state_dict)
        if report_pixels is not None:
            quant_report = weights_only_report(
                model_cfg, state_dict, qparams, report_pixels,
                normalize_imagenet=normalize_imagenet,
                input_affine=input_affine, device=dev)
        program = build_infer_fn_w8(
            model_cfg, qparams, normalize_imagenet=normalize_imagenet,
            input_affine=input_affine, device=dev)
    elif quantize is not None:
        raise ValueError(f"unknown quantize scheme {quantize!r}")
    else:
        program = build_infer_fn(model_cfg, state_dict,
                                 normalize_imagenet=normalize_imagenet,
                                 input_affine=input_affine, device=dev)
    example = torch.zeros((2, s, s, 3), dtype=torch.uint8, device=dev)
    batch: int | str
    with torch.no_grad():
        try:
            dim = torch.export.Dim("b", max=MAX_BATCH)
            exported = torch.export.export(
                program, (example,), dynamic_shapes=({0: dim},))
            batch = "symbolic"
        except Exception as e:
            # loud, not silent: a real export bug is not to be mistaken
            # for a dynamic-shape limitation
            print(f"symbolic-batch export failed ({type(e).__name__}: "
                  f"{e}); falling back to a fixed batch of {FIXED_BATCH}")
            exported = torch.export.export(program, (torch.zeros(
                (FIXED_BATCH, s, s, 3), dtype=torch.uint8, device=dev),))
            batch = FIXED_BATCH
    _, _, (lo, hi) = artifact_spec(exported)
    torch.export.save(exported, out_path)
    _check_exported(program, torch.export.load(out_path).module(), s,
                    max(lo, min(3, hi)), dev)
    manifest = {
        "format": "torch.export/ExportedProgram",
        "input": {"shape": [batch, s, s, 3], "dtype": "uint8",
                  "layout": "NHWC, [0,255] pixels"},
        "outputs": ["log_probs", "pred", "p_malignant"],
        "class_names": list(class_names),
        "image_size": model_cfg.image_size,
        "canonical_size": s,
        "normalize_imagenet": bool(normalize_imagenet),
        "input_affine": input_affine,
        "quantization": (
            {"scheme": quantize,
             **({"calib_mode": calib_mode} if quantize == "int8" else {}),
             **(quant_report or {}),
             # the fidelity report scored the calibration rows themselves
             # (the train split was absent): its agreement is optimistic
             **({"report_on_calibration_rows": True}
                if report_on_calibration_rows and quant_report else {})}
            if quantize else None),
        "platforms": [dev.type],
        "model": model_cfg.name,
        "bytes": os.path.getsize(out_path),
        "experiment_folder": os.path.abspath(experiment_folder),
        "batch_range": [lo, hi],
        "torch": torch.__version__,
    }
    with open(out_path + MANIFEST_SUFFIX, "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def read_manifest(path: str) -> dict[str, Any]:
    """The artifact's manifest, or ``{}`` without one."""
    if not os.path.exists(path + MANIFEST_SUFFIX):
        return {}
    with open(path + MANIFEST_SUFFIX) as f:
        return json.load(f)


def load_program(path: str, device="cuda"):
    """The ``ExportedProgram`` at ``path``, for ``device``, which must be
    the device it was exported on (the manifest's ``platforms``)."""
    dev = resolve_device(device)
    platforms = read_manifest(path).get("platforms")
    if platforms and dev.type not in platforms:
        raise ValueError(f"{path} was exported for {platforms}; it cannot "
                         f"run on {dev.type}")
    return torch.export.load(path)


def load_exported(path: str, device="cuda") -> nn.Module:
    """The artifact at ``path`` as a callable module on ``device``."""
    return load_program(path, device).module()


def predict_exported(path: str, pixels: np.ndarray,
                     device="cuda") -> dict[str, np.ndarray]:
    """Load the artifact and run one batch on ``device``. A batch below
    the artifact's least rows (a fixed-batch artifact's batch, or a
    dynamic range that starts above 1) pads with zero rows and slices
    back; a batch above its most raises."""
    ep = load_program(path, device)
    _, _, (lo, hi) = artifact_spec(ep)
    pixels = np.asarray(pixels, np.uint8)
    n = pixels.shape[0]
    if n > hi:
        what = (f"was exported with a fixed batch of {hi}" if lo == hi
                else f"takes at most {hi} rows a call")
        raise ValueError(f"{path} {what}; got {n} rows — split the batch")
    if n < lo:
        pad = np.zeros((lo - n,) + pixels.shape[1:], pixels.dtype)
        pixels = np.concatenate([pixels, pad])
    x = torch.from_numpy(pixels).to(resolve_device(device))
    with torch.inference_mode():
        out = ep.module()(x)
    return {k: v.cpu().numpy()[:n] for k, v in out.items()}

"""Import the reference's trained ``session_model.pth`` checkpoints (port
of the JAX package's ``migrate.reference``).

The reference saves each run's model as a whole-module torch pickle
(``torch.save(model, 'session_model.pth')``). This module turns such a
file into the port's ``session_model.msgpack`` without importing the
reference's code or running the pickle (:mod:`.torch_pickle`):

- the architecture comes from the pickled module graph (the conv stack,
  kernel sizes, MLP widths, dropout rates and class count make a
  :class:`ModelConfig` of ``skin_cancer_list``): the reference's
  SkinCancerListModel and SkinCancerModel, and whatever its HPO search
  space builds;
- the weights copy as they are. The port's model flattens NCHW as the
  reference's module does, so unlike the JAX import the first dense
  layer needs no row permutation: conv kernels stay OIHW and linear
  weights ``[out, in]``;
- ``model.class_names`` goes into ``train_config.json``.

:func:`import_reference_experiment` converts a whole results folder
(the model, the split CSVs and the epoch-record JSONs) into one the
port's CLIs read as their own. ``save_model`` writes the JAX package's
bytes for the same weights, so the file equals the JAX import's.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Any

import torch

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.migrate.torch_pickle import (
    TorchPickleError,
    load_pth,
    named_modules,
    stub_kind,
)

__all__ = ["import_reference_model", "import_reference_experiment"]


def _pair(value: Any) -> tuple[int, int]:
    if isinstance(value, (tuple, list)):
        return int(value[0]), int(value[1])
    return int(value), int(value)


def _conv_entry(path: str, stub: Any) -> dict:
    params = getattr(stub, "_parameters", {})
    weight = params.get("weight")
    if weight is None or weight.ndim != 4:
        raise TorchPickleError(f"{path}: Conv2d without a 4-D weight")
    kh, kw = weight.shape[2], weight.shape[3]
    if kh != kw:
        raise TorchPickleError(
            f"{path}: non-square conv kernel {kh}x{kw} is outside the "
            "SkinCancerListModel family")
    stride = _pair(getattr(stub, "stride", 1))
    if stride != (1, 1):
        raise TorchPickleError(
            f"{path}: conv stride {stride} unsupported (family uses "
            "stride 1 + 2x2 max-pool)")
    padding = getattr(stub, "padding", "same")
    if not (padding == "same" or _pair(padding) == (kh // 2, kw // 2)):
        raise TorchPickleError(
            f"{path}: conv padding {padding!r} is not SAME for k={kh}")
    return {"path": path, "weight": weight, "bias": params.get("bias"),
            "kernel": kh, "in": weight.shape[1], "out": weight.shape[0]}


def _linear_entry(path: str, stub: Any) -> dict:
    params = getattr(stub, "_parameters", {})
    weight = params.get("weight")
    if weight is None or weight.ndim != 2:
        raise TorchPickleError(f"{path}: Linear without a 2-D weight")
    return {"path": path, "weight": weight, "bias": params.get("bias"),
            "in": weight.shape[1], "out": weight.shape[0]}


def import_reference_model(
    path: str,
) -> tuple[ModelConfig, dict[str, torch.Tensor], list[str]]:
    """Parse a reference ``session_model.pth`` (a whole-module pickle)
    and return ``(model_cfg, state_dict, class_names)``: the port's
    ``state_dict`` of ``skin_cancer_list``, float32 on the CPU, checked
    against the model's own before it is returned. ``compute_dtype`` is
    float32, so the imported model's forward matches the float32 module
    (bf16, the training default, can flip calls near p = 0.5)."""
    root = load_pth(path)
    if isinstance(root, dict):
        raise TorchPickleError(
            f"{path}: this is a state_dict, not a whole-module pickle; "
            "the reference saves whole modules. For torchvision backbone "
            "state_dicts use models.resnet.load_torchvision_weights.")

    convs: list[dict] = []
    linears: list[dict] = []
    dropouts: list[float] = []
    for mod_path, stub in named_modules(root):
        kind = stub_kind(stub)
        params = getattr(stub, "_parameters", None)
        has_params = isinstance(params, dict) and any(
            v is not None for v in params.values())
        if kind == "Conv2d":
            if linears:
                raise TorchPickleError(
                    f"{mod_path}: conv after linear layers is outside the "
                    "SkinCancerListModel family")
            convs.append(_conv_entry(mod_path, stub))
        elif kind == "Linear":
            linears.append(_linear_entry(mod_path, stub))
        elif kind in ("Dropout", "Dropout2d"):
            dropouts.append(float(getattr(stub, "p", 0.5)))
        elif has_params:
            raise TorchPickleError(
                f"{mod_path}: parameterized module {kind} is outside the "
                "SkinCancerListModel family (BatchNorm backbones load "
                "via the models.resnet / models.xception converters)")
        # parameter-free modules (activations, pools, containers) carry
        # nothing to import

    if not convs or not linears:
        raise TorchPickleError(
            f"{path}: expected a conv stack + linear head, found "
            f"{len(convs)} convs / {len(linears)} linears")
    for prev, nxt in zip(convs, convs[1:]):
        if nxt["in"] != prev["out"]:
            raise TorchPickleError(
                f"{nxt['path']}: conv in-channels {nxt['in']} do not "
                f"chain from {prev['path']} out-channels {prev['out']}")
    rest_kernels = {c["kernel"] for c in convs[1:]}
    if len(rest_kernels) > 1:
        raise TorchPickleError(
            f"{path}: mixed non-first conv kernels {sorted(rest_kernels)}")

    # the first linear's input is C_last * (S / 2^n_convs)^2
    c_last = convs[-1]["out"]
    flat_in = linears[0]["in"]
    if flat_in % c_last:
        raise TorchPickleError(
            f"{path}: flatten dim {flat_in} not divisible by final conv "
            f"channels {c_last}")
    hw = flat_in // c_last
    side = int(round(hw ** 0.5))
    if side * side != hw:
        raise TorchPickleError(
            f"{path}: flatten spatial size {hw} is not square")

    hidden, head = linears[:-1], linears[-1]
    for prev, nxt in zip(linears, linears[1:]):
        if nxt["in"] != prev["out"]:
            raise TorchPickleError(
                f"{nxt['path']}: linear in-features {nxt['in']} do not "
                f"chain from {prev['path']} out-features {prev['out']}")
    if dropouts and len(dropouts) not in (1, len(hidden)):
        raise TorchPickleError(
            f"{path}: {len(dropouts)} dropout layers for {len(hidden)} "
            "hidden linears")

    cfg = ModelConfig(
        name="skin_cancer_list",
        conv_features=tuple(c["out"] for c in convs),
        first_kernel=convs[0]["kernel"],
        kernel=(convs[1]["kernel"] if len(convs) > 1 else 3),
        linear_features=tuple(lin["out"] for lin in hidden),
        dropout=tuple(dropouts) if dropouts else (0.0,),
        num_classes=head["out"],
        image_size=side * (2 ** len(convs)),
        in_channels=convs[0]["in"],
        compute_dtype="float32",
    )

    state_dict: dict[str, torch.Tensor] = {}

    def put(prefix: str, entry: dict) -> None:
        bias = entry["bias"]
        if bias is None:
            bias = torch.zeros(entry["out"])
        state_dict[f"{prefix}.weight"] = entry["weight"].float().contiguous()
        state_dict[f"{prefix}.bias"] = bias.float().contiguous()

    for i, conv in enumerate(convs):
        put(f"conv_blocks.{i}", conv)
    for j, lin in enumerate(hidden):
        put(f"mlp_blocks.{j}", lin)
    put("head", head)
    _check_structure(cfg, state_dict, path)

    class_names = getattr(root, "class_names", None)
    if not isinstance(class_names, (list, tuple)) or not all(
            isinstance(c, str) for c in class_names):
        class_names = ["benign", "malignant"]
    return cfg, state_dict, list(class_names)


def _check_structure(cfg: ModelConfig, state_dict: dict[str, torch.Tensor],
                     path: str) -> None:
    """The names and shapes of ``state_dict`` against those of the model
    ``cfg`` builds on the meta device (no memory, no init)."""
    from skin_image_analysis_tpu_torch.models.registry import get_model

    expect = get_model(cfg.name)(cfg, device="meta").state_dict()
    want = {k: tuple(v.shape) for k, v in expect.items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    if want != got:
        missing = sorted(set(want) - set(got))
        extra = sorted(set(got) - set(want))
        wrong = sorted(k for k in set(want) & set(got) if want[k] != got[k])
        raise TorchPickleError(
            f"{path}: imported weights do not match the rebuilt model: "
            f"missing={missing} extra={extra} shape-mismatch="
            f"{[(k, got[k], want[k]) for k in wrong]}")


def import_reference_experiment(
    src_folder: str, out_folder: str, model_name: str = "session_model.pth"
) -> dict:
    """Convert a reference results folder into one of the port's:

    - ``session_model.pth`` -> ``session_model.msgpack``, and a
      ``train_config.json`` with the pickled class names;
    - the split CSVs and every ``*.json`` epoch-record file copy over
      under their own names.

    Returns a summary (the architecture, the parameter count, the files
    copied)."""
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib

    pth = os.path.join(src_folder, model_name)
    if not os.path.exists(pth):
        raise TorchPickleError(f"{pth}: no model file in {src_folder}")
    cfg, state_dict, class_names = import_reference_model(pth)

    os.makedirs(out_folder, exist_ok=True)
    ckpt_lib.save_model(os.path.join(out_folder, ckpt_lib.MODEL_FILENAME),
                        cfg, state_dict)
    with open(os.path.join(out_folder, "train_config.json"), "w") as f:
        json.dump({"class_names": class_names,
                   "image_size": cfg.image_size,
                   "imported_from": os.path.abspath(pth)}, f, indent=2)

    copied: list[str] = []
    for name in ("session_train.csv", "session_test.csv"):
        src = os.path.join(src_folder, name)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(out_folder, name))
            copied.append(name)
    for src in sorted(glob.glob(os.path.join(src_folder, "*.json"))):
        name = os.path.basename(src)
        dst = os.path.join(out_folder, name)
        if not os.path.exists(dst):
            shutil.copy2(src, dst)
            copied.append(name)

    return {
        "model": ckpt_lib.MODEL_FILENAME,
        "conv_features": list(cfg.conv_features),
        "first_kernel": cfg.first_kernel,
        "kernel": cfg.kernel,
        "linear_features": list(cfg.linear_features),
        "dropout": list(cfg.dropout),
        "num_classes": cfg.num_classes,
        "image_size": cfg.image_size,
        "class_names": class_names,
        "param_count": sum(v.numel() for v in state_dict.values()),
        "copied": copied,
    }

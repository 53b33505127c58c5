"""Import Keras 3 ``.keras`` model artifacts (port of the JAX package's
``migrate.keras_model``).

The reference's TF pipeline trains a transfer model
(``keras.applications.Xception(include_top=False)`` -> GAP ->
``Dense(num_classes, softmax)``, with ResNet50V2, MobileNetV2,
EfficientNetV2 and VGG19 as its alternatives) and saves it as
``skin_cancer_xception_model.keras``. This module turns such an artifact
into the port's experiment folder (``session_model.msgpack`` and
``train_config.json``), which the port's test, serve, export and train
CLIs read, as ``migrate.reference`` does for the torch
``session_model.pth``. Every Keras-compatible family of the port imports:
xception, resnet50/101/152_v2, efficientnet_b0-b7,
efficientnet_v2_b0-b3/s/m/l, vgg16/19 and mobilenet_v2, each through its
``apply_keras_*_weights`` mapping by layer name.

Two facts of the format shape it:

- Keras 3 stores ``model.weights.h5`` under structural names
  (``separable_conv2d_7``), not the layer names the mappings need, so the
  artifact is read by Keras itself: the importer needs ``keras`` (and
  its ``h5py``), and without it raises :class:`KerasImportError` naming
  it.
- The notebook feeds raw 0-255 images, the port's pipeline [0, 1]. The
  model's preprocessing layers (``Rescaling``, ``Normalization``) compose
  into one per-channel affine ``a*x + c``. A pure scale folds exactly
  into the stem conv's kernel (zero padding maps 0 to 0 under a scale);
  the ImageNet offset maps onto the pipeline's ``normalize_imagenet``
  with the residual scale folded into the stem; any other offset (the
  EfficientNetV2-S/M/L ``Rescaling(1/128, -1)``) rides as the pipeline's
  ``input_affine``, applied to the [0, 1] floats where the source model
  applied it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

import numpy as np
import torch

__all__ = [
    "KerasImportError",
    "compose_input_transform",
    "import_keras_experiment",
    "import_keras_model",
]


class KerasImportError(ValueError):
    """A .keras artifact this importer cannot convert faithfully."""


def _stage_counts(names: set[str]) -> tuple[int, ...]:
    """Blocks per stage of an EfficientNet (v1 or v2) from its
    ``block<s>..._project_conv`` layers."""
    counts = tuple(
        sum(1 for n in names
            if n.startswith(f"block{s}") and n.endswith("_project_conv"))
        for s in range(1, 8))
    return tuple(x for x in counts if x)


def _detect_family(
    all_names: list[str],
) -> list[tuple[str, Callable, str]]:
    """Candidate ``(registered name, apply_keras_*_weights, stem kernel
    key)`` triples from the layer names. Usually one; EfficientNet b1 and
    b2 share their block counts, and the caller's shape-checked mapping
    picks the one whose widths fit."""
    names = set(all_names)
    has_sep = any("_sepconv" in n for n in names)
    if "block1_conv1" in names and has_sep:
        from skin_image_analysis_tpu_torch.models.xception import (
            apply_keras_xception_weights,
        )

        sep_blocks = {n.split("_")[0] for n in names
                      if n.startswith("block") and "_sepconv" in n}
        middle = max(int(b[5:]) for b in sep_blocks) - 6
        variant = {8: "xception", 2: "xception_small"}.get(middle)
        if variant is None:
            raise KerasImportError(
                f"Xception with {middle} middle blocks has no registered "
                "equivalent (xception=8, xception_small=2)")
        return [(variant, apply_keras_xception_weights,
                 "block1_conv1.weight")]
    if "block5_conv3" in names and not has_sep:
        from skin_image_analysis_tpu_torch.models.vgg import (
            apply_keras_vgg_weights,
        )

        variant = "vgg19" if "block5_conv4" in names else "vgg16"
        return [(variant, apply_keras_vgg_weights, "block1_conv1.weight")]
    if "conv2_block1_preact_bn" in names and "post_bn" in names:
        from skin_image_analysis_tpu_torch.models.resnet_v2 import (
            DEPTHS,
            apply_keras_resnet_v2_weights,
        )

        depths = tuple(
            max(int(n.split("_block")[1].split("_")[0])
                for n in names if n.startswith(f"conv{s}_block"))
            for s in (2, 3, 4, 5))
        variant = {v: k for k, v in DEPTHS.items()}.get(depths)
        if variant is None:
            raise KerasImportError(
                f"ResNet-V2 with stack depths {depths} has no registered "
                f"equivalent ({dict(DEPTHS)})")
        return [(variant, apply_keras_resnet_v2_weights,
                 "conv1_conv.weight")]
    if "Conv_1_bn" in names and "expanded_conv_depthwise" in names:
        from skin_image_analysis_tpu_torch.models.mobilenet import (
            apply_keras_mobilenet_v2_weights,
        )

        return [("mobilenet_v2", apply_keras_mobilenet_v2_weights,
                 "Conv1.weight")]
    if "top_bn" in names and any("_dwconv2" in n for n in names):
        from skin_image_analysis_tpu_torch.models import efficientnet_v2

        counts = _stage_counts(names)
        variant = next((v for v in efficientnet_v2.VARIANTS
                        if efficientnet_v2.block_counts(v) == counts), None)
        if variant is None:
            raise KerasImportError(
                f"EfficientNetV2 with per-stage block counts {counts} has "
                "no registered equivalent (b0-b3, s, m, l)")
        return [(variant,
                 efficientnet_v2.apply_keras_efficientnet_v2_weights,
                 "stem_conv.weight")]
    if "top_bn" in names and any(n.endswith("_dwconv") for n in names):
        from skin_image_analysis_tpu_torch.models import efficientnet

        counts = _stage_counts(names)
        cands = [v for v in efficientnet.VARIANTS
                 if efficientnet.block_counts(v) == counts]
        if not cands:
            raise KerasImportError(
                f"EfficientNet (v1) with per-stage block counts {counts} "
                "has no registered equivalent (b0-b7)")
        return [(f"efficientnet_{v}",
                 efficientnet.apply_keras_efficientnet_weights,
                 "stem_conv.weight") for v in cands]
    raise KerasImportError(
        "unrecognized backbone — supported transfer families: Xception "
        "(the artifact the reference's TF notebook saves), "
        "ResNet50/101/152V2, EfficientNet (b0-b7), EfficientNetV2 "
        "(b0-b3/s/m/l), VGG16/19, "
        f"MobileNetV2 (alpha=1); found layers {all_names[:8]}... — torch "
        "checkpoints import via cli/import_reference.py, raw backbone "
        "weight files via the models.* load_keras_*_weights converters")


def compose_input_transform(
    pre_layers: list[tuple],
) -> tuple[np.ndarray, bool, tuple | None]:
    """The model's preprocessing stack as the port's input conventions:
    ``(per-channel stem fold, normalize_imagenet, input_affine)``.

    ``pre_layers`` lists the preprocessing layers in graph order:
    ``("rescaling", scale, offset)`` (scalar or per channel) or
    ``("normalization", mean, variance)``. They compose to ``y = a*x_raw +
    c``, which is ``(255a)*x01 + c`` of the pipeline's ``x01 =
    x_raw/255``. Then:

    - no offset: the pure scale folds into the stem kernel;
    - ``c == -(255a)*mean_imagenet``: the pipeline's
      ``normalize_imagenet`` (the same constants), the rest of the
      per-channel scale folded into the stem;
    - any other offset cannot fold through the stem's zero padding, so
      it is the pipeline's ``input_affine`` (scale, offset) on the [0, 1]
      floats."""
    a = np.full(3, 255.0)
    c = np.zeros(3)
    for layer in pre_layers:
        kind = layer[0]
        if kind == "rescaling":
            s = np.broadcast_to(np.asarray(layer[1], np.float64).ravel(),
                                (3,))
            o = np.broadcast_to(np.asarray(layer[2], np.float64).ravel(),
                                (3,))
            a, c = s * a, s * c + o
        elif kind == "normalization":
            m = np.broadcast_to(np.asarray(layer[1], np.float64).ravel(),
                                (3,))
            std = np.sqrt(np.broadcast_to(
                np.asarray(layer[2], np.float64).ravel(), (3,)))
            a, c = a / std, (c - m) / std
        else:
            raise KerasImportError(f"unknown preprocessing layer {kind}")
    if np.allclose(c, 0.0, atol=1e-9):
        return a.astype(np.float32), False, None
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )

    mean = np.asarray(IMAGENET_MEAN, np.float64)
    std = np.asarray(IMAGENET_STD, np.float64)
    if np.allclose(c, -a * mean, rtol=1e-6, atol=1e-9):
        return (a * std).astype(np.float32), True, None
    affine = (tuple(float(v) for v in a), tuple(float(v) for v in c))
    return np.ones(3, np.float32), False, affine


def _default_class_names(num_classes: int) -> list[str]:
    if num_classes == 2:
        return ["benign", "malignant"]
    if num_classes == 7:
        from skin_image_analysis_tpu_torch.data.ham import DX_CLASSES

        return list(DX_CLASSES)
    return [f"class_{i}" for i in range(num_classes)]


def _pre_layers(model) -> list[tuple]:
    """The model's ``Rescaling`` / ``Normalization`` layers in graph
    order, as :func:`compose_input_transform` takes them."""
    out = []
    for layer in model.layers:
        cls = layer.__class__.__name__
        if cls == "Rescaling":
            out.append(("rescaling", np.asarray(layer.scale, np.float64),
                        np.asarray(getattr(layer, "offset", 0.0) or 0.0,
                                   np.float64)))
        elif cls == "Normalization":
            out.append(("normalization",
                        np.asarray(layer.mean, np.float64),
                        np.asarray(layer.variance, np.float64)))
    return out


def import_keras_model(
    path: str, image_size: int | None = None
) -> tuple[Any, dict[str, torch.Tensor], dict]:
    """Parse a ``.keras`` transfer artifact and return ``(model_cfg,
    state_dict, meta)``: the port's whole ``state_dict`` of the
    ``build_model(model_cfg)`` model (BatchNorm statistics included), on
    the CPU, with the 0-255 input convention folded as the module
    docstring says. ``image_size`` sets the size where the saved model's
    spatial dims are dynamic; a static input wins. ``compute_dtype`` is
    float32, as the torch import's, so the forward matches the source."""
    try:
        import keras
    except ImportError as e:
        raise KerasImportError(
            f"importing .keras artifacts requires keras: {e}") from e

    from skin_image_analysis_tpu_torch.config import ModelConfig
    from skin_image_analysis_tpu_torch.models.keras_io import read_live_model
    from skin_image_analysis_tpu_torch.models.registry import get_model

    try:
        model = keras.saving.load_model(path, compile=False)
    except Exception as e:
        raise KerasImportError(f"{path}: not a loadable .keras: {e}") from e

    candidates = _detect_family([layer.name for layer in model.layers])

    # the transfer head: exactly one Dense
    dense = [layer for layer in model.layers
             if layer.__class__.__name__ == "Dense" and layer.get_weights()]
    if len(dense) != 1:
        raise KerasImportError(f"expected exactly one Dense head, found "
                               f"{[layer.name for layer in dense]}")
    head = dense[0]
    num_classes = int(head.get_weights()[0].shape[-1])
    fold, normalize_imagenet, input_affine = compose_input_transform(
        _pre_layers(model))

    shape = tuple(model.input.shape)  # (None, H, W, C)
    if len(shape) != 4 or shape[3] not in (3, None):
        raise KerasImportError(f"unsupported input shape {shape}")
    if shape[1] is not None:
        if shape[1] != shape[2]:
            raise KerasImportError(
                f"non-square input {shape} has no ModelConfig equivalent")
        size = int(shape[1])
    else:
        size = int(image_size or 224)

    try:
        layer_names, table = read_live_model(model)
    except ValueError as e:
        raise KerasImportError(str(e)) from e
    # the preprocessing layers fold through compose_input_transform
    backbone_names = [n for n in layer_names if n != head.name
                      and not n.startswith(("rescaling", "normalization"))]

    errors: list[str] = []
    for variant, apply_fn, stem_key in candidates:
        cfg = ModelConfig(name=variant, num_classes=num_classes,
                          image_size=size, compute_dtype="float32")
        target = get_model(variant)(cfg, device="meta").state_dict()
        consumed: set[str] = set()

        def weights_of(name: str) -> dict:
            consumed.add(name)
            return table[name]

        try:
            state_dict = apply_fn(backbone_names, weights_of, target)
            break
        except (KeyError, ValueError) as e:
            errors.append(f"{variant}: {e}")
    else:
        raise KerasImportError(
            "weight mapping failed for every candidate variant "
            "(width-scaled or non-standard model?): " + "; ".join(errors))

    leftovers = set(backbone_names) - consumed
    if leftovers:
        raise KerasImportError(
            f"weighted layers the {variant} mapping does not consume: "
            f"{sorted(leftovers)}")

    # the head: Keras's kernel is [in, out], the port's [out, in]
    hw = torch.from_numpy(np.ascontiguousarray(table[head.name]["kernel"].T))
    hb = torch.from_numpy(np.ascontiguousarray(table[head.name]["bias"]))
    for key, val in (("head.weight", hw), ("head.bias", hb)):
        if tuple(state_dict[key].shape) != tuple(val.shape):
            raise KerasImportError(
                f"head {key}: {tuple(val.shape)} vs "
                f"{tuple(state_dict[key].shape)} — the backbone feature "
                "width does not match")
        state_dict[key] = val.float()

    if not np.allclose(fold, 1.0):
        # per input channel: W (a x) == (a W) x along C_in
        state_dict[stem_key] = state_dict[stem_key] * torch.from_numpy(
            fold.reshape(1, 3, 1, 1))

    remaining = [k for k, v in state_dict.items() if v.is_meta]
    if remaining:
        raise KerasImportError(f"unconverted model tensors: {remaining[:6]}")

    meta = {
        "backbone": variant,
        "num_classes": num_classes,
        "image_size": size,
        "input_scale_folded": (float(fold[0]) if np.allclose(fold, fold[0])
                               else [float(v) for v in fold]),
        "normalize_imagenet": normalize_imagenet,
        "input_affine": ([list(v) for v in input_affine]
                         if input_affine is not None else None),
        "head_layer": head.name,
        "param_count": sum(v.numel() for k, v in state_dict.items()
                           if not k.endswith(("running_mean",
                                              "running_var"))),
    }
    return cfg, state_dict, meta


def import_keras_experiment(
    path: str,
    out_folder: str,
    class_names: list[str] | None = None,
    image_size: int | None = None,
) -> dict:
    """Convert a ``.keras`` artifact into an experiment folder the port's
    CLIs read (``session_model.msgpack`` and ``train_config.json``, the
    transfer trainers' layout)."""
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib

    cfg, state_dict, meta = import_keras_model(path, image_size=image_size)
    names = list(class_names or _default_class_names(meta["num_classes"]))
    if len(names) != meta["num_classes"]:
        raise KerasImportError(
            f"{len(names)} class names for {meta['num_classes']} classes")

    os.makedirs(out_folder, exist_ok=True)
    ckpt_lib.save_model(os.path.join(out_folder, ckpt_lib.MODEL_FILENAME),
                        cfg, state_dict)
    with open(os.path.join(out_folder, "train_config.json"), "w") as f:
        json.dump({
            # normalize_imagenet only where the artifact embeds the
            # ImageNet normalization the pipeline's flag reproduces
            "data": {
                "normalize_imagenet": meta["normalize_imagenet"],
                **({"input_affine": meta["input_affine"]}
                   if meta["input_affine"] is not None else {}),
            },
            "class_names": names,
            "image_size": cfg.image_size,
            "imported_from": os.path.abspath(path),
            "keras_import": meta,
        }, f, indent=2)
    return {"model": ckpt_lib.MODEL_FILENAME, "class_names": names, **meta}

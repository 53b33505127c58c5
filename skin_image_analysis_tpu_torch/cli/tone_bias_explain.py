"""The explainability CLI of the port (counterpart of the JAX package's
``cli.tone_bias_explain``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_explain \\
        <image root> <experiment folder>
        [--method ig|saliency|smoothgrad|gradientshap|occlusion|gradcam]
        [--n-images 6] [--steps 200] [--best] [--bench]
        [--device cuda|cpu]

Attributes the first N rows of the folder's ``session_test.csv``, decoded
at the model's input size, at their predicted class, and writes an
original | heat map | blended triptych per image to
``<folder>/explain/<method>_<image name>.png``. ``--bench`` first prints
one JSON line of the attribution's time (``compile_s``: the first call's
excess over a warm call). Grad-CAM and occlusion maps are upsampled
bilinearly to the image size. :func:`explain` is the attribution step
without the figures.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from skin_image_analysis_tpu_torch.cli._common import (
    input_convention,
    model_file,
    parse,
)
from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.ingest import read_csv
from skin_image_analysis_tpu_torch.data.loader import HostImageStore
from skin_image_analysis_tpu_torch.explain import attribution as attr_lib
from skin_image_analysis_tpu_torch.explain.occlusion import occlusion_map
from skin_image_analysis_tpu_torch.explain.viz import (
    visualize_attribution_triptych,
)
from skin_image_analysis_tpu_torch.models.cnn import (
    SkinCancerListModel,
    build_model,
)
from skin_image_analysis_tpu_torch.ops.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib
from skin_image_analysis_tpu_torch.train.loop import (
    TEST_SET_FILENAME,
    resolve_device,
)

METHODS = ("ig", "saliency", "smoothgrad", "gradientshap", "occlusion",
           "gradcam")
BENCH_ITERS = 3


class Batch(NamedTuple):
    """A folder's model and its first test rows: ``images`` the ``[B, H,
    W, 3]`` [0, 1] floats, ``x`` the model's input made from them."""
    model: nn.Module
    model_cfg: ModelConfig
    table: LesionTable
    images: torch.Tensor
    x: torch.Tensor


class Explained(NamedTuple):
    """What :func:`explain` returns, on the host: the [0, 1] images, the
    attributions (``[B, H, W, C]``, or ``[B, H, W, 1]`` maps), the
    predicted classes, the class probabilities, the rows' table and the
    ``--bench`` record (None without ``bench``)."""
    images: np.ndarray
    attributions: np.ndarray
    preds: np.ndarray
    probs: np.ndarray
    table: LesionTable
    bench: dict | None


def _model_input(images: torch.Tensor, folder: str) -> torch.Tensor:
    """The folder's model-input convention applied to [0, 1] images:
    ImageNet normalization, an input affine, or the images as they are."""
    norm, affine = input_convention(folder)
    if norm:
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        return (images - mean) / std
    if affine is not None:
        scale = torch.tensor(affine[0], device=images.device)
        offset = torch.tensor(affine[1], device=images.device)
        return images * scale + offset
    return images


def load_batch(root: str, folder: str, n_images: int = 6,
               best: bool = False, device="cuda") -> Batch:
    """The folder's model (eval) and the first ``n_images`` rows of its
    test split, decoded at the model's input size, on ``device``."""
    dev = resolve_device(device)
    test = read_csv(os.path.join(folder, TEST_SET_FILENAME), index_col=True)
    model_cfg, state_dict = ckpt_lib.load_model(model_file(folder, best))
    model = build_model(model_cfg, device=dev)
    model.load_state_dict(state_dict)
    model.eval()
    table = LesionTable(test.take(range(min(n_images, len(test)))), root)
    store = HostImageStore(table, canonical_size=model_cfg.image_size)
    images = (torch.from_numpy(store.images).to(dev).permute(0, 2, 3, 1)
              .float() / 255.0)
    return Batch(model, model_cfg, table, images,
                 _model_input(images, folder))


def predict(model: nn.Module, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(predicted classes, class probabilities) of one eval forward."""
    with torch.no_grad():
        log_probs = model(x)
    return log_probs.argmax(dim=-1), log_probs.exp()


def upsample(maps: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``[B, h, w]`` maps -> ``[B, H, W, 1]``, bilinear with half-pixel
    centres (``jax.image.resize``'s ``"bilinear"`` when upsampling)."""
    up = F.interpolate(maps[:, None].float(), size=(height, width),
                       mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)


def attribute(model: nn.Module, x: torch.Tensor, preds: torch.Tensor,
              method: str, n_steps: int = 200) -> torch.Tensor:
    """One method's attributions of ``x`` at the classes ``preds``, as the
    CLI computes them: SmoothGrad and GradientShap draw from a generator
    seeded 0; occlusion's patch is max(4, H // 7) with stride max(2,
    patch // 2); Grad-CAM is :func:`grad_cam` for the flagship models and
    :func:`grad_cam_gap_head` for every other family. Maps come back
    upsampled to ``[B, H, W, 1]``."""
    h, w = x.shape[1:3]
    if method == "ig":
        return attr_lib.integrated_gradients(model, x, preds,
                                             n_steps=n_steps)
    if method == "saliency":
        return attr_lib.saliency(model, x, preds)
    gen = torch.Generator(device=x.device).manual_seed(0)
    if method == "smoothgrad":
        return attr_lib.smoothgrad(model, x, preds, gen)
    if method == "gradientshap":
        return attr_lib.gradient_shap(model, x, preds, gen, n_steps=n_steps)
    if method == "occlusion":
        patch = max(4, h // 7)
        return upsample(occlusion_map(model, x, preds, patch_size=patch,
                                      stride=max(2, patch // 2)), h, w)
    if method == "gradcam":
        if isinstance(model, SkinCancerListModel):
            cam = attr_lib.grad_cam(model, x, preds)
        else:
            cam = attr_lib.grad_cam_gap_head(model, x, preds)
        return upsample(cam, h, w)
    raise SystemExit(f"unknown method {method!r}; one of {METHODS}")


def _timed(fn, device: torch.device) -> tuple[torch.Tensor, float]:
    """fn()'s result fetched to the host, and the seconds it took, the
    card synchronized before each clock reading."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn().cpu()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def bench_record(batch: Batch, preds: torch.Tensor, method: str,
                 n_steps: int) -> tuple[dict, torch.Tensor]:
    """The ``--bench`` record (the JAX package's keys, unrounded) and the
    attributions: one first call, then :data:`BENCH_ITERS` warm calls."""
    def fn():
        return attribute(batch.model, batch.x, preds, method, n_steps)

    attr, first_s = _timed(fn, batch.x.device)
    total = 0.0
    for _ in range(BENCH_ITERS):
        attr, s = _timed(fn, batch.x.device)
        total += s
    batch_s = total / BENCH_ITERS
    n = len(batch.x)
    return {
        "method": method, "n_images": n, "steps": int(n_steps),
        "image_size": batch.model_cfg.image_size,
        "model": batch.model_cfg.name, "compile_s": first_s - batch_s,
        "s_per_batch": batch_s, "img_per_min": n / batch_s * 60,
    }, attr


def explain(root: str, folder: str, method: str = "ig", n_images: int = 6,
            n_steps: int = 200, best: bool = False, bench: bool = False,
            device="cuda") -> Explained:
    """The CLI's attribution step: :func:`load_batch`, :func:`predict`,
    then :func:`attribute` (timed by :func:`bench_record` with
    ``bench``)."""
    if method not in METHODS:
        raise SystemExit(f"unknown method {method!r}; one of {METHODS}")
    batch = load_batch(root, folder, n_images, best, device)
    preds, probs = predict(batch.model, batch.x)
    record = None
    if bench:
        record, attr = bench_record(batch, preds, method, n_steps)
    else:
        attr = attribute(batch.model, batch.x, preds, method, n_steps)
    return Explained(batch.images.cpu().numpy(), attr.cpu().numpy(),
                     preds.cpu().numpy(), probs.cpu().numpy(), batch.table,
                     record)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(
        argv, {"method": "ig", "n-images": 6, "steps": 200,
               "device": "cuda"},
        bool_flags={"best", "bench"})
    if len(positional) != 2:
        print("Usage: <root directory of ISIC images> <experiment folder> "
              "[--method ig|saliency|smoothgrad|gradientshap|occlusion|"
              "gradcam] [--n-images N] [--steps N] [--best] [--bench] "
              "[--device cuda|cpu]")
        return 1
    root, folder = positional
    method = opts["method"]
    out = explain(root, folder, method, opts["n-images"], opts["steps"],
                  opts["best"], opts["bench"], opts["device"])
    if out.bench is not None:
        rec = dict(out.bench)
        rec["compile_s"] = round(rec["compile_s"], 1)
        rec["s_per_batch"] = round(rec["s_per_batch"], 3)
        rec["img_per_min"] = round(rec["img_per_min"], 1)
        print(json.dumps(rec), flush=True)

    out_dir = os.path.join(folder, "explain")
    os.makedirs(out_dir, exist_ok=True)
    table = out.table
    for i in range(len(table)):
        inst = table.instance(i)
        pred = int(out.preds[i])
        title = (f"{inst['image_name']} pred={table.class_names[pred]} "
                 f"p={out.probs[i][pred]:.2f} "
                 f"actual={inst['benign_malignant']} "
                 f"tone={inst['skin_tone']}")
        path = os.path.join(out_dir, f"{method}_{inst['image_name']}.png")
        visualize_attribution_triptych(out.images[i], out.attributions[i],
                                       title=title, save_path=path)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

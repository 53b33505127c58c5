"""The input pipeline, plainly, and the random draws of a train step.

Train: crop ``t x t`` at each image's offset from its ``s x s`` frame,
flip it left to right where drawn, scale to [0, 1], then colour jitter
(brightness multiplies; contrast scales about the image's mean over all
pixels and channels; saturation scales about the luma 0.299 R + 0.587 G +
0.114 B; then clip to [0, 1]), then the configured normalization. Eval:
scale to [0, 1] and resize the frame to ``t x t`` (bilinear, with
antialiasing when downscaling), then normalize. Output NHWC float32.

A train step draws, from the run's generator and in this order: the crop
offsets (``randint(0, s - t + 1, (B, 2))``, int32), the flips
(``rand(B) < 0.5``), one ``(1 - h) + 2h * rand(B)`` factor for each
jitter of half-range ``h > 0`` (brightness, contrast, saturation), then
the model's dropout noise, ``rand(B, width)`` for each dropping layer in
order. That is the order in which the program under test documents its
draws (its data-parallel step draws them so to hand each rank its rows).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)


class StepDraws(NamedTuple):
    offsets: torch.Tensor                 # [B, 2] (y0, x0)
    flips: torch.Tensor                   # [B] bool
    jitter: tuple                         # brightness, contrast, saturation
    noise: list                           # dropout noise, one per layer


def draw_step(generator: torch.Generator, b: int, s: int, t: int,
              augment: dict, widths: list[int]) -> StepDraws:
    """One train step's draws, in the program's order (module doc)."""
    dev = generator.device
    if augment["random_crop"] and s > t:
        offsets = torch.randint(0, s - t + 1, (b, 2), generator=generator,
                                device=dev, dtype=torch.int32)
    else:
        offsets = torch.full((b, 2), (s - t) // 2, dtype=torch.int32,
                             device=dev)
    if augment["horizontal_flip"]:
        flips = torch.rand(b, generator=generator, device=dev) < 0.5
    else:
        flips = torch.zeros(b, dtype=torch.bool, device=dev)
    jitter = []
    for key in ("brightness", "contrast", "saturation"):
        h = augment[key]
        jitter.append(None if h <= 0 else (1 - h) + 2 * h * torch.rand(
            b, generator=generator, device=dev))
    noise = [torch.rand((b, w), generator=generator, device=dev)
             for w in widths]
    return StepDraws(offsets, flips, tuple(jitter), noise)


def _normalize(x: torch.Tensor, normalize_imagenet: bool) -> torch.Tensor:
    """NCHW [0, 1] floats -> the model's input scale."""
    if not normalize_imagenet:
        return x
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def train_batch(arena: torch.Tensor, rows: torch.Tensor, draws: StepDraws,
                t: int, normalize_imagenet: bool) -> torch.Tensor:
    """The augmented NHWC float32 batch of arena ``rows``."""
    frames = arena[rows.long()]
    crops = torch.stack([
        frames[i, :, y:y + t, x:x + t]
        for i, (y, x) in enumerate(draws.offsets.tolist())])
    crops = torch.where(draws.flips[:, None, None, None],
                        crops.flip(3), crops)
    x = crops.float() / 255.0
    brightness, contrast, saturation = draws.jitter
    if brightness is not None:
        x = x * brightness[:, None, None, None]
    if contrast is not None:
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) * contrast[:, None, None, None] + mean
    if saturation is not None:
        gray = (LUMA[0] * x[:, 0:1] + LUMA[1] * x[:, 1:2]
                + LUMA[2] * x[:, 2:3])
        x = (x - gray) * saturation[:, None, None, None] + gray
    if any(j is not None for j in draws.jitter):
        x = x.clamp(0.0, 1.0)
    return _normalize(x, normalize_imagenet).permute(0, 2, 3, 1)


def eval_batch(arena: torch.Tensor, rows: torch.Tensor, t: int,
               normalize_imagenet: bool) -> torch.Tensor:
    """The NHWC float32 eval batch of arena ``rows``: the whole frame
    resized."""
    x = arena[rows.long()].float() / 255.0
    if x.shape[-1] != t or x.shape[-2] != t:
        x = F.interpolate(x, size=(t, t), mode="bilinear",
                          align_corners=False, antialias=True)
    return _normalize(x, normalize_imagenet).permute(0, 2, 3, 1)

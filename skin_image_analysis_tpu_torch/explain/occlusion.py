"""Occlusion sensitivity maps (port of the JAX package's
``explain.occlusion``): slide a patch of ``fill`` over the image and
measure the drop in the target log-probability.

The occluded variants of every patch position go through the model as
the rows of batches of at most ``attribution.ROWS_PER_PASS`` rows.
"""

from __future__ import annotations

import torch
from torch import nn

from skin_image_analysis_tpu_torch.explain.attribution import _chunks


def occlusion_map(model: nn.Module, x: torch.Tensor, target: torch.Tensor,
                  patch_size: int = 16, stride: int = 8,
                  fill: float = 0.5) -> torch.Tensor:
    """``[B, H, W, C]`` images -> ``[B, ny, nx]`` score drops, one per
    patch position (larger: a more important region)."""
    b, h, w, _ = x.shape
    ys = torch.arange(0, h - patch_size + 1, stride, device=x.device)
    xs = torch.arange(0, w - patch_size + 1, stride, device=x.device)
    y0 = ys.repeat_interleave(len(xs))  # positions in row-major order
    x0 = xs.repeat(len(ys))
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    fill_t = torch.tensor(fill, dtype=x.dtype, device=x.device)

    def score(imgs: torch.Tensor) -> torch.Tensor:
        k = imgs.shape[0] // b
        return model(imgs).gather(1, target.repeat(k)[:, None])[:, 0]

    drops = []
    with torch.no_grad():
        base = score(x)
        for pos in _chunks(len(y0), b):
            in_rows = ((rows >= y0[pos, None])
                       & (rows < y0[pos, None] + patch_size))
            in_cols = ((cols >= x0[pos, None])
                       & (cols < x0[pos, None] + patch_size))
            mask = (in_rows[:, :, None] & in_cols[:, None, :])
            occluded = torch.where(mask[:, None, :, :, None], fill_t, x)
            k = occluded.shape[0]
            drops.append(base.repeat(k)
                         - score(occluded.flatten(0, 1)))
    grid = torch.cat(drops).reshape(len(ys), len(xs), b)
    return grid.permute(2, 0, 1)

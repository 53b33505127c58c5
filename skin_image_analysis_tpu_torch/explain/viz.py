"""Attribution figures (port of the JAX package's ``explain.viz``): the
Captum-style triptych (original | heat map | blended) with the
reference's white-to-black colormap, and the test CLI's grid of
predictions. numpy and matplotlib only; matplotlib is imported at first
use (``utils.pyplot``)."""

from __future__ import annotations

import math

import numpy as np

from skin_image_analysis_tpu_torch.utils.pyplot import pyplot


def _attr_to_heat(attribution: np.ndarray) -> np.ndarray:
    """``[H, W, C]`` signed attribution -> ``[H, W]`` magnitude scaled to
    [0, 1] by its 98th percentile (Captum's outlier-robust scale)."""
    heat = np.abs(attribution).sum(axis=-1)
    scale = np.percentile(heat, 98)
    return np.clip(heat / max(scale, 1e-12), 0.0, 1.0)


def visualize_attribution_triptych(image: np.ndarray,
                                   attribution: np.ndarray, title: str = "",
                                   save_path: str | None = None):
    """original | heat map | blended heat map; returns the figure (closed
    once saved to ``save_path``)."""
    plt = pyplot()
    from matplotlib.colors import LinearSegmentedColormap

    cmap = LinearSegmentedColormap.from_list(
        "white_black", [(1, 1, 1), (0, 0, 0)], N=256)
    heat = _attr_to_heat(np.asarray(attribution))
    image = np.clip(np.asarray(image), 0.0, 1.0)

    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    axes[0].imshow(image)
    axes[0].set_title("Original")
    im = axes[1].imshow(heat, cmap=cmap)
    axes[1].set_title("Attribution")
    fig.colorbar(im, ax=axes[1], fraction=0.046)
    axes[2].imshow(image)
    axes[2].imshow(heat, cmap="jet", alpha=0.5)
    axes[2].set_title("Blended")
    for ax in axes:
        ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def visualize_predictions_grid(images: np.ndarray, pred_names: list[str],
                               true_names: list[str], n_images: int = 6,
                               save_path: str | None = None):
    """A grid of ``[N, H, W, C]`` [0, 1] images titled ``predicted: X``
    and ``actual: Y``, green where they agree and red where not (the
    reference's ``visualize_model``)."""
    plt = pyplot()
    n = min(n_images, len(images))
    cols = min(n, 3)
    rows = math.ceil(n / cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i >= n:
            continue
        ax.imshow(np.clip(images[i], 0, 1))
        ok = pred_names[i] == true_names[i]
        ax.set_title(f"predicted: {pred_names[i]}\nactual: {true_names[i]}",
                     color="green" if ok else "red", fontsize=10)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig

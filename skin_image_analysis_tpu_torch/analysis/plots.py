"""Result figures (port of the JAX package's ``analysis.plots``): the
twin-axis DI and loss figure and the accuracy figure.

The DI figure has the training loss on the right axis, tone and control
DI on the left, dashed lines at the four-fifths band's 1.2 and 0.80 and a
left y-max of 1.3, saved as ``figure_<prefix>.png``; the accuracy figure
has the majority classifier's accuracy (0.74 imbalanced, 0.55 balanced)
as its floor. matplotlib is imported at first use (``utils.pyplot``).
"""

from __future__ import annotations

import os
from typing import Any

from skin_image_analysis_tpu_torch.utils.pyplot import pyplot

DI_UPPER = 1.2
DI_LOWER = 0.80
MAJORITY_ACC = {"imbalanced": 0.74, "balanced": 0.55}


def plot_di_figure(aggregate: dict[str, Any], prefix: str,
                   save_dir: str = ".", show_ci: bool = True) -> str:
    """Render and save ``figure_<prefix>.png``; returns its path."""
    plt = pyplot()
    epochs = aggregate["epochs"]
    mean, ci = aggregate["mean"], aggregate["ci"]

    fig, ax_di = plt.subplots(figsize=(8, 5))
    ax_loss = ax_di.twinx()

    def band(ax, key, color):
        if show_ci and key in ci:
            ax.fill_between(epochs, [c[0] for c in ci[key]],
                            [c[1] for c in ci[key]], alpha=0.15,
                            color=color)

    if "tone_di" in mean:
        ax_di.plot(epochs, mean["tone_di"], color="tab:red", label="Tone DI")
        band(ax_di, "tone_di", "tab:red")
    if "control_di" in mean:
        ax_di.plot(epochs, mean["control_di"], color="tab:green",
                   label="Control DI")
        band(ax_di, "control_di", "tab:green")
    if "avg_batch_loss" in mean:
        ax_loss.plot(epochs, mean["avg_batch_loss"], color="tab:blue",
                     label="Training loss", alpha=0.7)
        ax_loss.set_ylabel("Training loss")

    ax_di.axhline(DI_UPPER, linestyle="--", color="gray",
                  label="Biased DI (1.2)")
    ax_di.axhline(DI_LOWER, linestyle="--", color="black",
                  label="Unbias DI (0.80)")
    ax_di.set_ylim(0, 1.3)
    ax_di.set_xlabel("Epoch")
    ax_di.set_ylabel("Disparate impact")
    ax_di.set_title(f"{prefix} (n={aggregate.get('n_runs', 0)} runs)")
    ax_di.legend(loc="lower right", fontsize=8)

    out = os.path.join(save_dir, f"figure_{prefix}.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def plot_accuracy_figure(aggregate: dict[str, Any], prefix: str,
                         save_dir: str = ".") -> str:
    """Render and save ``figure_<prefix>_accuracy.png`` (test and train
    accuracy, AUC, the majority classifier's floor); returns its path."""
    plt = pyplot()
    epochs = aggregate["epochs"]
    mean = aggregate["mean"]
    fig, ax = plt.subplots(figsize=(8, 5))
    if "accuracy" in mean:
        ax.plot(epochs, mean["accuracy"], label="Test accuracy")
    if "train_accuracy" in mean:
        ax.plot(epochs, mean["train_accuracy"], label="Train accuracy")
    floor = MAJORITY_ACC.get(prefix)
    if floor:
        ax.axhline(floor, linestyle="--", color="gray",
                   label=f"Majority classifier ({floor})")
    if "auc" in mean:
        ax.plot(epochs, mean["auc"], label="Test AUC")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Accuracy")
    ax.set_ylim(0, 1)
    ax.legend(loc="lower right", fontsize=8)
    ax.set_title(prefix)
    out = os.path.join(save_dir, f"figure_{prefix}_accuracy.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out

"""The results-analysis CLI of the port (counterpart of the JAX package's
``cli.tone_bias_analysis``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_analysis \\
        <balanced|imbalanced> <epoch_to_detail> [--experiments-dir DIR]

Aggregates every experiment folder under DIR (default ``results``) whose
name starts with the prefix, averaging each measure over the runs with 90%
confidence intervals, prints the requested epoch's means, and writes
``figure_<prefix>.png`` (DI and loss) and ``figure_<prefix>_accuracy.png``
into DIR. Host code only: it runs no model.
"""

from __future__ import annotations

import sys

from skin_image_analysis_tpu_torch.analysis import read_experiments
from skin_image_analysis_tpu_torch.analysis.plots import (
    plot_accuracy_figure,
    plot_di_figure,
)
from skin_image_analysis_tpu_torch.cli._common import parse


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(argv, {"experiments-dir": "results"})
    if len(positional) != 2:
        print("Usage: <balanced|imbalanced> <epoch_to_detail> "
              "[--experiments-dir DIR]")
        return 1
    prefix, epoch_to_detail = positional[0], int(positional[1])
    exp_dir = opts["experiments-dir"]

    agg = read_experiments(exp_dir, prefix)
    if not agg["epochs"]:
        print(f"No experiments matching {prefix}* under {exp_dir}")
        return 1
    print(f"Aggregated {agg['n_runs']} runs: {agg['experiments']}")

    if epoch_to_detail < len(agg["epochs"]):
        print(f"\nEpoch {epoch_to_detail} detail (mean over runs):")
        for key in sorted(agg["mean"]):
            value = agg["mean"][key][epoch_to_detail]
            lo, hi = agg["ci"][key][epoch_to_detail]
            print(f"  {key}: {value:.4f}  (90% CI [{lo:.4f}, {hi:.4f}])")
    else:
        print(f"epoch_to_detail {epoch_to_detail} out of range "
              f"({len(agg['epochs'])} epochs)")

    for path in (plot_di_figure(agg, prefix, save_dir=exp_dir),
                 plot_accuracy_figure(agg, prefix, save_dir=exp_dir)):
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The export CLI of the port (counterpart of the JAX package's
``cli.tone_bias_export``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_export \\
        <experiment folder> <out path> [--canonical-size N]
        [--platforms cuda] [--normalize-imagenet] [--best]
        [--device cuda|cpu]

Writes the whole inference program (uint8 pixels -> preprocess ->
forward -> {log_probs, pred, p_malignant}) as a ``torch.export`` program
with a dynamic batch: one file with the weights inside, served by
``torch.export.load`` or ``tone_bias_serve`` without the model's Python
code, and a JSON manifest beside it. The artifact runs on the device it
was exported on (``--device``; ``--platforms`` may only name it).

Refused until ROADMAP queue 1 item 10 part 2 ports them: ``--quantize``,
``--calib-root``, ``--calib-rows`` and ``--calib-mode``.
"""

from __future__ import annotations

import os
import sys

from skin_image_analysis_tpu_torch.cli._common import (
    given,
    model_file,
    parse,
    refuse,
)

_UNPORTED = {
    flag: "ROADMAP queue 1 item 10 part 2, serve/quantize.py"
    for flag in ("quantize", "calib-root", "calib-rows", "calib-mode")
}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(
        argv, {"canonical-size": 0, "platforms": "", "quantize": "",
               "calib-root": "", "calib-rows": 256, "calib-mode": "max",
               "device": "cuda"},
        bool_flags={"normalize-imagenet", "best"},
    )
    if len(positional) != 2:
        print("Usage: <experiment folder> <out path> "
              "[--canonical-size N] [--platforms cuda] "
              "[--normalize-imagenet] [--best] [--device cuda|cpu]")
        return 1
    refuse({flag: flag in given(argv) for flag in _UNPORTED}, _UNPORTED)
    folder, out_path = positional

    from skin_image_analysis_tpu_torch.serve import export_model

    manifest = export_model(
        folder, out_path,
        model_filename=os.path.basename(
            model_file(folder, best=opts["best"])),
        canonical_size=opts["canonical-size"] or None,
        # True forces it; None reads the folder's train_config.json
        normalize_imagenet=opts["normalize-imagenet"] or None,
        platforms=(
            [p.strip() for p in opts["platforms"].split(",") if p.strip()]
            or None
        ),
        device=opts["device"],
    )
    print(f"exported {manifest['bytes'] / 1e6:.1f} MB "
          f"({manifest['model']}, batch={manifest['input']['shape'][0]}, "
          f"platforms={manifest['platforms']}) -> {out_path}")
    print(f"manifest: {out_path}.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

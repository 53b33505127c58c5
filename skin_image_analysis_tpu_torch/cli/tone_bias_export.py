"""The export CLI of the port (counterpart of the JAX package's
``cli.tone_bias_export``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_export \\
        <experiment folder> <out path> [--canonical-size N]
        [--platforms cuda] [--normalize-imagenet] [--best]
        [--quantize int8|int8-weights --calib-root <image root>
         [--calib-rows N] [--calib-mode max|percentile[:p]]]
        [--device cuda|cpu]

Writes the whole inference program (uint8 pixels -> preprocess ->
forward -> {log_probs, pred, p_malignant}) as a ``torch.export`` program
with a dynamic batch: one file with the weights inside, served by
``torch.export.load`` or ``tone_bias_serve`` without the model's Python
code, and a JSON manifest beside it. The artifact runs on the device it
was exported on (``--device``; ``--platforms`` may only name it).

``--quantize int8`` exports the int8 program of ``serve.quantize``,
calibrated on the first ``--calib-rows`` rows of the folder's
``session_train.csv`` under ``--calib-root``, with the fidelity report on
``session_test.csv`` in the manifest; ``--quantize int8-weights`` works on
any model family and needs no calibration (``--calib-root`` there only
feeds the report).
"""

from __future__ import annotations

import os
import sys

from skin_image_analysis_tpu_torch.cli._common import model_file, parse


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
              "[--normalize-imagenet] [--best] "
              "[--quantize int8|int8-weights --calib-root <image root> "
              "[--calib-rows N] [--calib-mode max|percentile[:p]]]  "
              "(int8-weights works on ANY model "
              "family and needs no calibration; --calib-root there "
              "only feeds the fidelity report) [--device cuda|cpu]")
        return 1
    folder, out_path = positional

    from skin_image_analysis_tpu_torch.serve import export_model

    calib = report = None
    report_is_calib = False
    if opts["quantize"]:
        if not opts["calib-root"] and opts["quantize"] != "int8-weights":
            print("--quantize int8 needs --calib-root (the image root; "
                  "calibration rows come from the experiment's "
                  "session_train.csv, the fidelity report from "
                  "session_test.csv)")
            return 1
        if opts["calib-root"]:
            # weight-only quantization reads only the report's rows
            calib, report, report_is_calib = _load_calibration(
                folder, opts["calib-root"], int(opts["calib-rows"]),
                report_only=opts["quantize"] == "int8-weights")

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
        quantize=opts["quantize"] or None,
        calib_mode=opts["calib-mode"],
        calib_pixels=calib,
        report_pixels=report,
        report_on_calibration_rows=report_is_calib,
        device=opts["device"],
    )
    if manifest.get("quantization"):
        print(f"quantization: {manifest['quantization']}")
    print(f"exported {manifest['bytes'] / 1e6:.1f} MB "
          f"({manifest['model']}, batch={manifest['input']['shape'][0]}, "
          f"platforms={manifest['platforms']}) -> {out_path}")
    print(f"manifest: {out_path}.json")
    return 0


def _load_calibration(folder: str, root: str, n_rows: int,
                      report_only: bool = False):
    from skin_image_analysis_tpu_torch.serve.quantize import (
        calibration_rows,
    )

    try:
        return calibration_rows(folder, root, n_rows,
                                report_only=report_only)
    except ValueError as e:
        raise SystemExit(str(e))


if __name__ == "__main__":
    raise SystemExit(main())

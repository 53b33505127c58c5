"""Import a reference model artifact into a port experiment folder
(counterpart of the JAX package's ``cli.import_reference``)::

    python -m skin_image_analysis_tpu_torch.cli.import_reference \\
        <reference results folder | session_model.pth> <out folder>
    python -m skin_image_analysis_tpu_torch.cli.import_reference \\
        skin_cancer_xception_model.keras <out folder> \\
        [--classes a,b,...] [--image-size N]

The torch path turns the reference's whole-module ``session_model.pth``
pickle into ``session_model.msgpack`` without importing the reference's
code or running the pickle, and copies the split CSVs and the
epoch-record JSON files. The Keras path (a ``.keras`` first argument)
turns the TF pipeline's saved transfer model into the same artifacts,
with its input convention folded into the stem or carried in
``train_config.json``; it needs keras (and its h5py). ``--classes``
names the labels (default benign,malignant, or the 7 HAM dx classes);
``--image-size`` sets the size where the artifact's spatial dims are
dynamic. ``--device`` (``cuda`` by default, or ``cpu``) is where the
imported model is built once to check it: a forward of one zero image,
whose log-probs must be finite.

The output folder then works with the port's ``tone_bias_test``,
``tone_bias_serve``, ``tone_bias_export`` and ``tone_bias_train`` (to
continue training).
"""

from __future__ import annotations

import json
import os
import sys

from skin_image_analysis_tpu_torch.cli._common import parse

USAGE = (
    "Usage: <reference experiment folder | session_model.pth | "
    "model.keras> <output folder> [--classes a,b,...] [--image-size N] "
    "[--device cuda|cpu]"
)


def check_folder(folder: str, device: str) -> None:
    """Build the folder's model on ``device`` and run one zero image
    through it; a non-finite log-prob raises ValueError."""
    import torch

    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    dev = resolve_device(device)
    model_cfg, state_dict = ckpt_lib.load_model(
        os.path.join(folder, ckpt_lib.MODEL_FILENAME))
    model = build_model(model_cfg, device=dev)
    model.load_state_dict(state_dict)
    model.eval()
    side = model_cfg.image_size
    with torch.no_grad():
        log_probs = model(torch.zeros(1, side, side, model_cfg.in_channels,
                                      device=dev), train=False)
    if not torch.isfinite(log_probs).all():
        raise ValueError(f"{folder}: the imported model's log-probs are "
                         f"not finite: {log_probs.tolist()}")


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        pos, opts = parse(argv, {"classes": "", "image-size": 0,
                                 "device": "cuda"})
    except SystemExit as e:
        print(e)
        print(USAGE)
        return 1
    if len(pos) != 2:
        print(USAGE)
        print("Example: ref_results/balanced_2024-10-12_09-22-38 "
              "results/imported_balanced_2024-10-12_09-22-38")
        return 1
    src, out = pos

    if src.endswith(".keras"):
        from skin_image_analysis_tpu_torch.migrate import (
            KerasImportError,
            import_keras_experiment,
        )

        try:
            summary = import_keras_experiment(
                src, out,
                class_names=[c for c in opts["classes"].split(",") if c]
                or None,
                image_size=opts["image-size"] or None)
        except KerasImportError as e:
            print(f"import failed: {e}")
            return 1
    else:
        from skin_image_analysis_tpu_torch.migrate import (
            TorchPickleError,
            import_reference_experiment,
        )

        if os.path.isfile(src):
            folder, model_name = os.path.split(src)
        else:
            folder, model_name = src, "session_model.pth"
        try:
            summary = import_reference_experiment(folder, out,
                                                  model_name=model_name)
        except TorchPickleError as e:
            print(f"import failed: {e}")
            return 1
    check_folder(out, opts["device"])
    print(json.dumps(summary, indent=2))
    print(f"imported -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The HAM-10000 training CLI (counterpart of the JAX package's
``cli.ham_train``)::

    python -m skin_image_analysis_tpu_torch.cli.ham_train \\
        <image root> <metadata csv> <epochs> [--classes binary|dx]
        [--model NAME] [--batch-size N] [--lr F] [--image-size N]
        [--canonical-size N] [--freeze-backbone]
        [--keep-best accuracy|auc|f1|loss] [--early-stop N]
        [--steps-per-dispatch N] [--seed N] [--out DIR]
        [--device cuda|cpu]

``binary`` trains benign/malignant (mel, bcc and akiec malignant);
``dx`` the 7-class ``dx`` labels. Rows without ``<image_id>.jpg`` are
dropped, the rest split 70/30 by a seeded permutation. The default model
is ``xception`` (the reference's HAM transfer model); ``--model`` takes
any registered name, as ``tone_classifier_train``'s does. ``--device`` is
``cuda`` by default, ``cpu`` for the plain versions on the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from skin_image_analysis_tpu_torch.cli._common import init_runtime, parse
from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.ham import (
    DX_CLASSES,
    read_ham_metadata,
)
from skin_image_analysis_tpu_torch.train.classify import (
    ClassifyConfig,
    train_classifier,
)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(
        argv,
        {"classes": "binary", "model": "xception", "batch-size": 32,
         "lr": 1e-3, "image-size": 224, "canonical-size": 256,
         "out": "ham_runs", "seed": 0, "steps-per-dispatch": 8,
         "keep-best": "", "early-stop": 0, "device": "cuda"},
        bool_flags={"freeze-backbone"},
    )
    init_runtime(opts["device"])
    if len(positional) != 3:
        print("Usage: <image root> <metadata csv> <epochs> "
              "[--classes binary|dx] [--model NAME] "
              "[--keep-best METRIC] [--early-stop N] ...")
        return 1
    root, csv_path, epochs = positional[0], positional[1], int(positional[2])

    df = read_ham_metadata(csv_path)
    df = df.take(i for i, image_id in enumerate(df.column("isic_id"))
                 if os.path.exists(os.path.join(root, f"{image_id}.jpg")))
    rng = np.random.default_rng(opts["seed"])
    order = rng.permutation(len(df))
    cut = int(0.7 * len(df))
    train_df = df.take(order[:cut])
    test_df = df.take(order[cut:])

    if opts["classes"] == "dx":
        kw = dict(class_names=DX_CLASSES, label_column="dx")
        n_classes = 7
    else:
        kw = {}
        n_classes = 2
    train_table = LesionTable(train_df, root, **kw)
    test_table = LesionTable(test_df, root, **kw)

    cfg = ClassifyConfig(
        model_name=opts["model"], num_classes=n_classes,
        image_size=opts["image-size"], canonical_size=opts["canonical-size"],
        batch_size=opts["batch-size"], epochs=epochs,
        learning_rate=opts["lr"], seed=opts["seed"], out_dir=opts["out"],
        freeze_backbone=opts["freeze-backbone"],
        steps_per_dispatch=opts["steps-per-dispatch"],
        checkpoint_best=bool(opts["keep-best"]),
        best_metric=opts["keep-best"] or "accuracy",
        early_stop_patience=int(opts["early-stop"]),
    )
    out = train_classifier(train_table, test_table, cfg,
                           device=opts["device"])
    print(f"final test metrics: {out['test_metrics']}")
    print(f"model artifact: {out['model_path']} (serve/export with "
          "tone_bias_serve.py / tone_bias_export.py)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

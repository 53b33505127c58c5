"""The skin-tone classifier's training CLI (counterpart of the JAX
package's ``cli.tone_classifier_train``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_classifier_train \\
        <image root> <epochs> [--model resnet50|resnet34|resnet18|
        xception|vgg16|mobilenet_v2|efficientnet_b0|...] [--batch-size N]
        [--lr F] [--image-size N] [--canonical-size N] [--oversample]
        [--freeze-backbone] [--input rgb|ita] [--five-crop]
        [--keep-best accuracy|auc|f1|loss] [--early-stop N]
        [--steps-per-dispatch N] [--no-class-weights] [--seed N]
        [--out DIR] [--device cuda|cpu]

Reads ``<root>/metadata.csv``, keeps the rows with a Fitzpatrick type,
splits them 70/30 (seeded), and trains the ResNet transfer model on
{light, dark} labels (I/II light, III-VI dark; rows without
``<isic_id>.jpg`` dropped) with class-weighted loss, crop + flip +
ImageNet augmentation and AdamW, logging per-step losses and per-epoch
accuracy, precision, recall, F1 and AUC to ``<out>/metrics.jsonl``.
``--input ita`` trains on the two ITA channels (ITA/90 of the skin
pixels and the skin mask, ``data.ita``) in place of the normalized RGB.
``--model`` takes any registered name: the ResNets, ``resnet50_v2`` /
``101_v2`` / ``152_v2``, ``xception``, ``vgg16`` / ``vgg19``,
``mobilenet_v2``, ``efficientnet_b0`` ... ``b7``, ``efficientnet_v2_b0``
... ``b3`` / ``s`` / ``m`` / ``l`` and the flagship models. ``--device``
is ``cuda`` by default, ``cpu`` for the plain versions on the CPU.
"""

from __future__ import annotations

import os
import sys

from skin_image_analysis_tpu_torch.cli._common import init_runtime, parse
from skin_image_analysis_tpu_torch.data.ingest import read_csv, shuffle_split
from skin_image_analysis_tpu_torch.toneclassifier.trainer import (
    ToneTrainConfig,
    train_tone_classifier,
)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(
        argv,
        {"model": "resnet50", "batch-size": 32, "lr": 1e-3,
         "image-size": 224, "out": "tone_runs", "seed": 0,
         "canonical-size": 256, "input": "rgb",
         "steps-per-dispatch": 8, "keep-best": "", "early-stop": 0,
         "device": "cuda"},
        bool_flags={"oversample", "no-class-weights", "freeze-backbone",
                    "five-crop"},
    )
    init_runtime(opts["device"])
    if len(positional) != 2:
        print("Usage: <image root> <epochs> [--model NAME] [--batch-size N]"
              " [--lr F] [--image-size N] [--oversample]"
              " [--freeze-backbone] [--input rgb|ita] [--five-crop]"
              " [--keep-best METRIC] [--early-stop N]"
              " [--no-class-weights] [--out DIR]")
        return 1
    root, epochs = positional[0], int(positional[1])

    df = read_csv(os.path.join(root, "metadata.csv"))
    df = df.where("fitzpatrick_skin_type", lambda v: v is not None)
    train_df, test_df = shuffle_split(df, ratio=0.7, seed=opts["seed"])

    cfg = ToneTrainConfig(
        model_name=opts["model"],
        image_size=opts["image-size"],
        canonical_size=opts["canonical-size"],
        batch_size=opts["batch-size"],
        epochs=epochs,
        learning_rate=opts["lr"],
        use_class_weights=not opts["no-class-weights"],
        oversample=opts["oversample"],
        freeze_backbone=opts["freeze-backbone"],
        input_mode=opts["input"],
        five_crop_eval=opts["five-crop"],
        seed=opts["seed"],
        out_dir=opts["out"],
        steps_per_dispatch=opts["steps-per-dispatch"],
        keep_best=opts["keep-best"],
        early_stop_patience=int(opts["early-stop"]),
    )
    out = train_tone_classifier(train_df, test_df, root, cfg,
                                device=opts["device"])
    print(f"final test metrics: {out['test_metrics']}")
    print(f"metrics log: {os.path.join(cfg.out_dir, 'metrics.jsonl')}")
    print(f"model artifact: {out['model_path']} (serve/export with "
          "tone_bias_serve.py / tone_bias_export.py)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

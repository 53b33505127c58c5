"""Tone-classifier trainer: ResNet transfer on {light, dark} (port of the
JAX package's ``toneclassifier.trainer``).

A ResNet backbone with a Dropout(0.5) + Dense(2) head, class-weighted
loss, AdamW at lr 1e-3, train augmentation random crop + horizontal flip
+ ImageNet normalization, per-epoch accuracy, precision, recall and F1,
and an optional oversampler drawing with replacement. Labels:
Fitzpatrick I/II -> light (0), III-VI -> dark (1); rows whose
``<isic_id>.jpg`` is not on disk are dropped. The loop is
``train.classify.train_classifier``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.ingest import Frame
from skin_image_analysis_tpu_torch.train.classify import (
    ClassifyConfig,
    train_classifier,
)


@dataclass(frozen=True)
class ToneTrainConfig:
    model_name: str = "resnet50"
    image_size: int = 224
    canonical_size: int = 256
    batch_size: int = 32
    epochs: int = 10
    learning_rate: float = 1e-3     # AdamW
    weight_decay: float = 0.01
    use_class_weights: bool = True
    oversample: bool = False        # draw with replacement, class-weighted
    freeze_backbone: bool = False   # train the head only
    input_mode: str = "rgb"         # "ita": the ITA channels (data.ita)
    five_crop_eval: bool = False    # five-crop test-time augmentation
    seed: int = 0
    compute_dtype: str = "bfloat16"
    out_dir: str = "tone_runs"
    steps_per_dispatch: int = 1     # train steps / eval batches a call
    keep_best: str = ""             # metric -> save session_model_best
    early_stop_patience: int = 0    # stop after N non-improving epochs


class ToneTable(LesionTable):
    """LesionTable with skin-tone labels (light=0, dark=1) in place of the
    diagnosis, over the rows with a Fitzpatrick type and a ``.jpg`` on
    disk."""

    def __init__(self, metadata: Frame, root_dir: str):
        df = metadata.where("fitzpatrick_skin_type", lambda v: v is not None)
        df = df.take(i for i, isic_id in enumerate(df.column("isic_id"))
                     if os.path.exists(os.path.join(root_dir,
                                                    f"{isic_id}.jpg")))
        df = df.with_column("tone_label", [
            "light" if t in ("I", "II") else "dark"
            for t in df.column("fitzpatrick_skin_type")])
        super().__init__(df, root_dir, class_names=("light", "dark"),
                         label_column="tone_label")


def train_tone_classifier(
    train_df: Frame,
    test_df: Frame,
    root_dir: str,
    cfg: ToneTrainConfig = ToneTrainConfig(),
    verbose: bool = True,
    device="cuda",
) -> dict:
    """Returns {state, history, test_metrics, out_dir, model_path}."""
    return train_classifier(
        ToneTable(train_df, root_dir),
        ToneTable(test_df, root_dir),
        ClassifyConfig(
            model_name=cfg.model_name,
            num_classes=2,
            image_size=cfg.image_size,
            canonical_size=cfg.canonical_size,
            batch_size=cfg.batch_size,
            epochs=cfg.epochs,
            learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay,
            optimizer="adamw",
            use_class_weights=cfg.use_class_weights,
            oversample=cfg.oversample,
            freeze_backbone=cfg.freeze_backbone,
            input_mode=cfg.input_mode,
            five_crop_eval=cfg.five_crop_eval,
            augment=True,
            normalize_imagenet=True,
            seed=cfg.seed,
            compute_dtype=cfg.compute_dtype,
            out_dir=cfg.out_dir,
            steps_per_dispatch=cfg.steps_per_dispatch,
            checkpoint_best=bool(cfg.keep_best),
            best_metric=cfg.keep_best or "accuracy",
            early_stop_patience=cfg.early_stop_patience,
        ),
        verbose=verbose,
        device=device,
    )

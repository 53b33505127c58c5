"""The transfer models' epochs: the calls ``train.classify.
train_classifier`` makes each epoch, without its file writes and logs.

Per epoch: the seeded shuffle (its ``BatchIterator``'s rule);
``train.loop.super_batches`` -> ``train.step.multi_train_step`` over the
device arena, ``k`` steps a call, the last partial batch dropped; the
losses and counts fetched once; the audit over the whole test arena,
``super_batches(..., with_row_ids=True)`` -> ``train.step.
multi_eval_step``, its predictions fetched once, ->
``train.classify.multiclass_metrics``. The train state is
``train.state.create_train_state``'s and the preprocess functions
``ops.preprocess.make_preprocess_fn``'s, at the settings
``train_classifier`` derives from the configuration's ``ClassifyConfig``
(class weights balanced over the train labels; crop and flip;
ImageNet normalization; ``freeze_backbone`` trains the head alone).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.epochs import Cell, Epoch
from port_bench.reference import resnet
from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig
from skin_image_analysis_tpu_torch.ops.preprocess import (
    AugmentConfig,
    make_preprocess_fn,
)
from skin_image_analysis_tpu_torch.toneclassifier.class_weight import (
    balanced_class_weights,
)
from skin_image_analysis_tpu_torch.train.classify import (
    ClassifyConfig,
    multiclass_metrics,
)
from skin_image_analysis_tpu_torch.train.loop import super_batches
from skin_image_analysis_tpu_torch.train.state import create_train_state
from skin_image_analysis_tpu_torch.train.step import (
    multi_eval_step,
    multi_train_step,
)


class TransferEpochs(Cell):
    reference = resnet

    def build(self) -> None:
        cfg = ClassifyConfig(**self.spec["config"]["program"]["classify"],
                             batch_size=self.batch, seed=self.seed)
        self.cfg = cfg
        model_cfg = ModelConfig(
            name=cfg.model_name, num_classes=cfg.num_classes,
            image_size=cfg.image_size, compute_dtype=cfg.compute_dtype,
            freeze_backbone=cfg.freeze_backbone, in_channels=3)
        optim_cfg = OptimConfig(optimizer=cfg.optimizer,
                                learning_rate=cfg.learning_rate,
                                weight_decay=cfg.weight_decay)
        self.state = create_train_state(model_cfg, optim_cfg, cfg.seed,
                                        self.device)
        self.class_weights = (
            tuple(balanced_class_weights(self.cohort.train_labels,
                                         cfg.num_classes))
            if cfg.use_class_weights else None)
        self.train_pre = make_preprocess_fn(
            cfg.image_size, train=True,
            augment=AugmentConfig(random_crop=True, horizontal_flip=True)
            if cfg.augment else None,
            normalize_imagenet=cfg.normalize_imagenet, layout="planar")
        self.eval_pre = make_preprocess_fn(
            cfg.image_size, train=False,
            normalize_imagenet=cfg.normalize_imagenet, layout="planar")
        self.k = max(1, cfg.steps_per_dispatch)
        self.train_ok = np.ones(self.cohort.train_arena.shape[0], bool)
        self.test_ok = np.ones(self.cohort.test_arena.shape[0], bool)

    def train_calls(self, order: np.ndarray) -> list[dict]:
        c = self.cohort
        return [
            multi_train_step(self.state, c.train_arena, ib, lb, vd,
                             self.class_weights, self.train_pre,
                             skip_empty=self.k > 1)
            for ib, lb, vd in super_batches(order, c.train_labels,
                                            self.batch, self.k,
                                            drop_remainder=True,
                                            row_ok=self.train_ok)]

    def fetch(self, metrics: list[dict]) -> Epoch:
        losses = torch.cat([m["loss"] for m in metrics]).cpu().numpy()
        counts = torch.cat([m["count"] for m in metrics]).cpu().numpy()
        live = counts > 0
        losses = losses[live] if self.k > 1 else losses
        self.last_loss = float(np.mean(losses)) if losses.size else 0.0
        return Epoch(int(counts.sum()), int(live.sum()),
                     int((~np.isfinite(losses)).sum()))

    def audit(self, capture: bool = False):
        c = self.cohort
        n = c.test_arena.shape[0]
        preds, log_probs, keep = [], [], []
        for ib, rid, vd in super_batches(np.arange(n), c.test_labels,
                                         self.batch, self.k,
                                         drop_remainder=False,
                                         with_row_ids=True,
                                         row_ok=self.test_ok):
            out = multi_eval_step(self.state.model, c.test_arena, ib, rid,
                                  vd, self.eval_pre)
            preds.append(out["pred"])
            log_probs.append(out["log_probs"])
            keep.append((ib, vd))
        pred = torch.cat(preds).reshape(-1).cpu().numpy()
        lp = torch.cat(log_probs).flatten(0, 1).cpu().numpy()
        valid = np.concatenate([v.reshape(-1) for _, v in keep])
        idx = np.concatenate([i.reshape(-1) for i, _ in keep])
        record = multiclass_metrics(pred[valid], c.test_labels[idx][valid],
                                    self.cfg.num_classes)
        if capture:
            return record, torch.from_numpy(lp[valid]).float()
        return record


Driver = TransferEpochs

"""The flagship's epochs: the calls ``train.loop.fit_arena`` makes each
epoch, without its file writes.

Per epoch: the seeded shuffle; ``train.loop.super_batches`` ->
``train.step.multi_train_step`` over the device arena, ``k`` steps a
call; the step metrics fetched once (loss, correct, count); the audit
over the whole test arena, ``super_batches(..., with_row_ids=True)`` ->
``train.evaluate.evaluate_fairness`` with the cohort's skin-tone, sex and
control codes. The train state is ``train.state.create_train_state``'s
and the preprocess functions ``ops.preprocess.make_preprocess_fn``'s, at
the settings ``fit_arena`` derives from the configuration's
``TrainConfig`` (its augmentation: crop, flip and the jitter the
configuration states).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.epochs import Cell, Epoch
from port_bench.reference import flagship
from skin_image_analysis_tpu_torch.config import train_config_from_dict
from skin_image_analysis_tpu_torch.models.cnn import stem_wants_s2d
from skin_image_analysis_tpu_torch.ops.preprocess import (
    AugmentConfig,
    make_preprocess_fn,
)
from skin_image_analysis_tpu_torch.train.evaluate import evaluate_fairness
from skin_image_analysis_tpu_torch.train.loop import super_batches
from skin_image_analysis_tpu_torch.train.state import create_train_state
from skin_image_analysis_tpu_torch.train.step import multi_train_step


class ArenaEpochs(Cell):
    reference = flagship

    def build(self) -> None:
        program = dict(self.spec["config"]["program"])
        data = dict(program["data"], batch_size=self.batch, seed=self.seed)
        cfg = train_config_from_dict({**program, "data": data,
                                      "seed": self.seed})
        self.cfg = cfg
        self.state = create_train_state(cfg.model, cfg.optim, cfg.seed,
                                        self.device)
        self.train_pre = make_preprocess_fn(
            cfg.data.image_size, train=True,
            augment=AugmentConfig(**self.spec["config"]["augment"]),
            normalize_imagenet=cfg.data.normalize_imagenet,
            input_affine=cfg.data.input_affine, layout="planar",
            out_dtype=cfg.model.compute_dtype,
            space_to_depth=stem_wants_s2d(cfg.model),
            pallas=cfg.data.pallas_preprocess)
        self.eval_pre = make_preprocess_fn(
            cfg.data.image_size, train=False,
            normalize_imagenet=cfg.data.normalize_imagenet,
            input_affine=cfg.data.input_affine, layout="planar")
        self.class_weights = cfg.optim.class_weights
        self.k = max(1, cfg.data.steps_per_dispatch)

    def train_calls(self, order: np.ndarray) -> list[dict]:
        c = self.cohort
        return [
            multi_train_step(self.state, c.train_arena, ib, lb, vd,
                             self.class_weights, self.train_pre)
            for ib, lb, vd in super_batches(order, c.train_labels,
                                            self.batch, self.k,
                                            self.cfg.data.drop_remainder)]

    def fetch(self, metrics: list[dict]) -> Epoch:
        losses, corr, counts = (
            torch.cat([m[key] for m in metrics]).cpu().numpy()
            for key in ("loss", "correct", "count"))
        live = counts > 0
        self.last_loss = float(losses[live].mean()) if live.any() else 0.0
        self.last_accuracy = int(corr.sum()) / max(int(counts.sum()), 1)
        return Epoch(int(counts.sum()), int(live.sum()),
                     int((~np.isfinite(losses[live])).sum()))

    def audit(self, capture: bool = False):
        c = self.cohort
        n = c.test_arena.shape[0]
        batches = super_batches(np.arange(n), c.test_labels, self.batch,
                                self.k, drop_remainder=False,
                                with_row_ids=True)
        outs = []
        hook = (self.state.model.register_forward_hook(
            lambda _m, _i, out: outs.append(out.detach().float()))
            if capture else None)
        try:
            record = evaluate_fairness(self.state.model, c.test_arena,
                                       batches, c.test_labels,
                                       c.test_groups, self.eval_pre)
        finally:
            if hook is not None:
                hook.remove()
        if capture:
            return record, torch.cat(outs)[:n]
        return record


Driver = ArenaEpochs

"""The HPO objective: short proxy-training of a sampled architecture (port
of the JAX package's ``hpo.objective``).

Behavior parity with the reference objective (tone_bias_optuna.py:234-288):
a 300-row sample of the tone metadata, 2/3-1/3 split, EPOCHS=10 epochs
with per-epoch caps (<=384 train, <=128 valid rows at batch 32),
per-epoch ``trial.report(accuracy, epoch)`` and the median-prune check,
returning the final validation accuracy.

One trial is one run of the port's train step (``train.step.train_step``,
the ``fit_arena`` form): the sampled rows live on the device once as a
planar uint8 arena and each batch is gathered from it by the fused
preprocess kernel, one launch a step (its plain twin on the CPU). The
JAX package's objective feeds the model the raw uint8 batch, which the
model casts to its compute dtype (values 0..255, no scaling); the kernel
therefore runs with scale 1 and no crop or flip, which reproduces that
input exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from skin_image_analysis_tpu_torch.config import HpoConfig
from skin_image_analysis_tpu_torch.hpo.space import define_isic_model
from skin_image_analysis_tpu_torch.hpo.study import TrialPruned
from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
    fused_preprocess_planar,
)
from skin_image_analysis_tpu_torch.train.state import create_train_state
from skin_image_analysis_tpu_torch.train.step import eval_step, train_step


class ArrayDataset:
    """In-memory (pixels uint8 [N,S,S,3], labels [N]) split."""

    def __init__(self, pixels: np.ndarray, labels: np.ndarray):
        self.pixels = pixels
        self.labels = labels.astype(np.int32)
        self._arena = None
        self._device_pixels = None

    def device_pixels(self, device) -> torch.Tensor:
        """The ``[N, S, S, 3]`` uint8 pixels on ``device``, copied once
        (the JAX dataset's ``device_pixels``; the trials gather from
        :meth:`arena`)."""
        if self._device_pixels is None:
            self._device_pixels = torch.from_numpy(
                np.ascontiguousarray(self.pixels)).to(device)
        return self._device_pixels

    def arena(self, device) -> torch.Tensor:
        """The planar ``[N, 3, S, S]`` uint8 arena on ``device``, made
        once."""
        if self._arena is None:
            self._arena = torch.from_numpy(np.ascontiguousarray(
                self.pixels.transpose(0, 3, 1, 2))).to(device)
        return self._arena

    def __len__(self) -> int:
        return len(self.labels)

    @staticmethod
    def sample_split(pixels: np.ndarray, labels: np.ndarray,
                     sample_size: int, seed: int,
                     train_fraction: float = 2 / 3,
                     ) -> tuple["ArrayDataset", "ArrayDataset"]:
        """Reference get_isic(): random sample -> 2/3-1/3 split
        (tone_bias_optuna.py:175-231)."""
        rng = np.random.default_rng(seed)
        n = min(sample_size, len(labels))
        idx = rng.permutation(len(labels))[:n]
        cut = int(train_fraction * n)
        return (ArrayDataset(pixels[idx[:cut]], labels[idx[:cut]]),
                ArrayDataset(pixels[idx[cut:]], labels[idx[cut:]]))


def raw_input(arena: torch.Tensor, generator=None, rows=None
              ) -> torch.Tensor:
    """Rows ``rows`` of the planar uint8 ``arena`` as float NHWC values
    0..255 (the JAX objective's uncast uint8 batch): one launch of the
    preprocess kernel with scale 1, no offset, no flip."""
    b, s = rows.shape[0], arena.shape[-1]
    dev = arena.device
    x = fused_preprocess_planar(
        arena, torch.zeros((b, 2), dtype=torch.int32, device=dev),
        torch.zeros(b, dtype=torch.int32, device=dev),
        torch.ones((b, 3), device=dev), torch.zeros((b, 3), device=dev),
        rows.to(torch.int32).contiguous(), image_size=s)
    return x.permute(0, 2, 3, 1)


def _batches(ds: ArrayDataset, batch_size: int, limit: int,
             rng: np.random.Generator):
    """Full batches of row indices, in ``rng``'s order, up to ``limit``
    rows."""
    order = rng.permutation(len(ds))
    stop = min(limit, (len(ds) // batch_size) * batch_size)
    for start in range(0, stop, batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size:
            return
        yield idx


def make_objective(train_pixels: np.ndarray, labels: np.ndarray,
                   cfg: HpoConfig = HpoConfig(),
                   image_size: int | None = None,
                   compute_dtype: str = "bfloat16", device="cuda"):
    """Build an ``objective(trial) -> accuracy`` over in-memory data, run
    on ``device``."""
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    dev = resolve_device(device)
    if image_size is None:
        image_size = train_pixels.shape[1]

    def objective(trial: Any) -> float:
        model_cfg, optim_cfg = define_isic_model(
            trial, image_size=image_size, compute_dtype=compute_dtype)
        rng = np.random.default_rng(cfg.seed + 1000 + trial.number)
        train_ds, valid_ds = ArrayDataset.sample_split(
            train_pixels, labels, cfg.sample_size, cfg.seed + trial.number)
        state = create_train_state(model_cfg, optim_cfg,
                                   cfg.seed + trial.number, device=dev)
        tr_arena, va_arena = train_ds.arena(dev), valid_ds.arena(dev)
        tr_lb = torch.as_tensor(train_ds.labels, device=dev)
        va_lb = valid_ds.labels
        valid = torch.ones(cfg.batch_size, dtype=torch.bool, device=dev)

        accuracy = 0.0
        for epoch in range(cfg.epochs):
            for idx in _batches(train_ds, cfg.batch_size,
                                cfg.n_train_examples, rng):
                rows = torch.as_tensor(idx, device=dev)
                train_step(state, tr_arena, tr_lb[rows], valid,
                           preprocess_fn=raw_input, rows=rows)
            correct = total = 0
            for idx in _batches(valid_ds, cfg.batch_size,
                                cfg.n_valid_examples, rng):
                rows = torch.as_tensor(idx, device=dev)
                out = eval_step(state.model, raw_input(va_arena, rows=rows),
                                rows)
                pred = out["pred"].cpu().numpy()
                correct += int((pred == va_lb[idx]).sum())
                total += len(pred)
            accuracy = correct / max(total, 1)
            trial.report(accuracy, epoch)
            if trial.should_prune():
                raise TrialPruned()
        return accuracy

    return objective

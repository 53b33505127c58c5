"""Stacked learning-rate populations of one architecture (port of the JAX
package's ``hpo.parallel``).

The reference parallelizes its sweep as independent MPI processes
(README.md:54). Here K trials of ONE architecture train as one stacked
program: parameters and Adam moments of the K trials are stacked on a
leading axis and stepped by ``torch.func.vmap`` of a ``functional_call``,
with the learning rate a per-trial value, K trials for roughly the
wall-clock of one. Different architectures go through ``hpo.wave``'s
padded super-networks.

Each step's batch is shared by the K trials, as in the JAX package: the
preprocess kernel converts its B rows once (``population.stacked_input``)
and every trial reads them. The stacked forward uses the stock pool
(``hpo.population`` says why). One device only: a mesh above 1 is refused
(ROADMAP queue 1 item 12).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any

import numpy as np
import torch
from torch.func import functional_call, grad, vmap

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.hpo.population import (
    _lane,
    init_opt_state,
    planar_pool,
    scale_updates,
    stacked_input,
)
from skin_image_analysis_tpu_torch.hpo.wave import MESH_UNPORTED


def _stack_batches(labels: np.ndarray, batch_size: int, seed: int
                   ) -> np.ndarray:
    """[n_batches, B] row indices, shared by the trials."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    n_batches = len(labels) // batch_size
    return order[: n_batches * batch_size].reshape(n_batches, batch_size)


def train_population(
    model_cfg: ModelConfig,
    learning_rates: np.ndarray,
    train_pixels: np.ndarray,
    train_labels: np.ndarray,
    valid_pixels: np.ndarray,
    valid_labels: np.ndarray,
    epochs: int = 10,
    batch_size: int = 32,
    seed: int = 0,
    mesh: int | None = None,
    device="cuda",
) -> dict[str, Any]:
    """Train K = len(learning_rates) stacked trials (Adam's update, the lr
    per trial); returns per-epoch validation accuracy [epochs, K] and the
    final stacked params. ``mesh`` is a device count; above 1 it is
    refused."""
    from skin_image_analysis_tpu_torch.models.cnn import build_model
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    if mesh is not None and int(mesh) > 1:
        raise NotImplementedError(MESH_UNPORTED)
    dev = resolve_device(device)
    k = len(learning_rates)
    cfg = replace(model_cfg, fused_pool=False, pool_mode="stock")
    lanes = [build_model(cfg, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed * 1009 + i)).state_dict()
             for i in range(k)]
    params = {n: torch.stack([sd[n] for sd in lanes]).float()
              for n in lanes[0]}
    opt = init_opt_state("adam", params)
    model = build_model(cfg, device=dev)
    for p in model.parameters():
        p.requires_grad_(False)
    rates = torch.tensor(model.dropout_rates, device=dev).expand(k, -1)
    lrs = torch.as_tensor(np.asarray(learning_rates, np.float32),
                          device=dev)

    n_tr = len(train_labels)
    pool = planar_pool(np.concatenate([train_pixels, valid_pixels]), dev)
    pool_lb = torch.as_tensor(np.concatenate(
        [train_labels, valid_labels]).astype(np.int64), device=dev)
    tb = torch.as_tensor(_stack_batches(train_labels, batch_size, seed),
                         device=dev)
    vb = torch.as_tensor(_stack_batches(valid_labels, batch_size, seed + 1)
                         + n_tr, device=dev)
    widths = [m.weight.shape[0] for m in model.mlp_blocks]

    def loss_fn(p, dr, x, labels, noise):
        log_probs = functional_call(model, p, (x,), {
            "train": True, "dropout_rates": dr, "dropout_noise": noise})
        return -log_probs.gather(1, labels[:, None])[:, 0].mean()

    vgrad = vmap(grad(loss_fn), in_dims=(0, 0, None, None, 0))

    def eval_one(p, x, labels):
        log_probs = functional_call(model, p, (x,), {"train": False})
        return (log_probs.argmax(-1) == labels).sum()

    veval = vmap(eval_one, in_dims=(0, None, None))
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    history = []
    for _ in range(epochs):
        for i in range(tb.shape[0]):
            rows = tb[i]
            noise = tuple(torch.rand((k, batch_size, w), generator=gen,
                                     device=dev) for w in widths)
            g = vgrad(params, rates, stacked_input(pool, rows),
                      pool_lb[rows], noise)
            upd, opt = scale_updates("adam", g, opt)
            params = {n: w - _lane(lrs, w) * upd[n]
                      for n, w in params.items()}
        with torch.no_grad():
            total = torch.zeros(k, dtype=torch.int64, device=dev)
            for i in range(vb.shape[0]):
                total += veval(params, stacked_input(pool, vb[i]),
                               pool_lb[vb[i]])
        history.append((total.double() / vb.numel()).cpu().numpy())
    return {
        "accuracy_history": np.stack(history),  # [epochs, K]
        "final_accuracy": history[-1],
        "params": params,
        "learning_rates": np.asarray(learning_rates),
    }

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
(``hpo.population`` says why). With a ``mesh`` whose ``trial_axis``
divides K, the trials split over the devices of that axis, one
``torch.func.vmap`` group each, as the JAX package shards its stacked
pytree; otherwise they run on ``device``.
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


def _stack_batches(labels: np.ndarray, batch_size: int, seed: int
                   ) -> np.ndarray:
    """[n_batches, B] row indices, shared by the trials."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(labels))
    n_batches = len(labels) // batch_size
    return order[: n_batches * batch_size].reshape(n_batches, batch_size)


def _trial_devices(mesh, trial_axis: str, k: int, device):
    """The devices the K trials split over: those of ``mesh``'s
    ``trial_axis`` when it divides K, else ``device`` alone."""
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    if mesh is None or k % mesh.shape[trial_axis]:
        return [resolve_device(device)]
    return [resolve_device(d) for d in mesh.axis_devices(trial_axis)]


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
    mesh=None,
    trial_axis: str = "data",
    device="cuda",
) -> dict[str, Any]:
    """Train K = len(learning_rates) stacked trials (Adam's update, the lr
    per trial); returns per-epoch validation accuracy [epochs, K] and the
    final stacked params (on the first device)."""
    from skin_image_analysis_tpu_torch.models.cnn import build_model

    k = len(learning_rates)
    devices = _trial_devices(mesh, trial_axis, k, device)
    dev = devices[0]
    g = k // len(devices)
    groups = [slice(i * g, (i + 1) * g) for i in range(len(devices))]
    cfg = replace(model_cfg, fused_pool=False, pool_mode="stock")
    lanes = [build_model(cfg, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed * 1009 + i)).state_dict()
             for i in range(k)]
    stacked = {n: torch.stack([sd[n] for sd in lanes]).float()
               for n in lanes[0]}
    params = [{n: v[sl].to(d) for n, v in stacked.items()}
              for d, sl in zip(devices, groups)]
    opt = [init_opt_state("adam", p) for p in params]
    models = {}
    for d in devices:
        if d not in models:
            models[d] = build_model(cfg, device=d)
            for p in models[d].parameters():
                p.requires_grad_(False)
    rates = torch.tensor(models[dev].dropout_rates, device=dev).expand(k, -1)
    lrs = torch.as_tensor(np.asarray(learning_rates, np.float32),
                          device=dev)

    n_tr = len(train_labels)
    tb = _stack_batches(train_labels, batch_size, seed)
    vb = _stack_batches(valid_labels, batch_size, seed + 1) + n_tr
    pixels = np.concatenate([train_pixels, valid_pixels])
    pool_lb = np.concatenate([train_labels, valid_labels]).astype(np.int64)
    per_device = {}
    for d in devices:
        if d not in per_device:
            per_device[d] = (planar_pool(pixels, d),
                             torch.as_tensor(pool_lb, device=d),
                             torch.as_tensor(tb, device=d),
                             torch.as_tensor(vb, device=d))
    widths = [m.features for m in models[dev].mlp_blocks]

    def programs(model):
        def loss_fn(p, dr, x, labels, noise):
            log_probs = functional_call(model, p, (x,), {
                "train": True, "dropout_rates": dr, "dropout_noise": noise})
            return -log_probs.gather(1, labels[:, None])[:, 0].mean()

        def eval_one(p, x, labels):
            log_probs = functional_call(model, p, (x,), {"train": False})
            return (log_probs.argmax(-1) == labels).sum()

        return (vmap(grad(loss_fn), in_dims=(0, 0, None, None, 0)),
                vmap(eval_one, in_dims=(0, None, None)))

    progs = {d: programs(m) for d, m in models.items()}
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    history = []
    for _ in range(epochs):
        for i in range(tb.shape[0]):
            noise = tuple(torch.rand((k, batch_size, w), generator=gen,
                                     device=dev) for w in widths)
            for j, (d, sl) in enumerate(zip(devices, groups)):
                pool, lb, tbd, _ = per_device[d]
                rows = tbd[i]
                gr = progs[d][0](params[j], rates[sl].to(d),
                                 stacked_input(pool, rows), lb[rows],
                                 tuple(t[sl].to(d) for t in noise))
                upd, opt[j] = scale_updates("adam", gr, opt[j])
                lr = lrs[sl].to(d)
                params[j] = {n: w - _lane(lr, w) * upd[n]
                             for n, w in params[j].items()}
        with torch.no_grad():
            total = []
            for j, d in enumerate(devices):
                pool, lb, _, vbd = per_device[d]
                acc = torch.zeros(g, dtype=torch.int64, device=d)
                for i in range(vbd.shape[0]):
                    acc += progs[d][1](params[j], stacked_input(pool, vbd[i]),
                                       lb[vbd[i]])
                total.append(acc.cpu())
        history.append((torch.cat(total).double() / vb.size).numpy())
    return {
        "accuracy_history": np.stack(history),  # [epochs, K]
        "final_accuracy": history[-1],
        "params": {n: torch.cat([p[n].to(dev) for p in params])
                   for n in params[0]},
        "learning_rates": np.asarray(learning_rates),
    }

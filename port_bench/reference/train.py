"""Train steps, plainly: forward in train mode, the class-weighted masked
NLL, the gradients by autograd, and optax's adam / adamw update.

Loss: ``-sum(w * log_p[label]) / max(sum(w), 1)`` with ``w`` a row's
validity times its label's class weight (1 without class weights).
Update (optax): ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``,
``u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``, plus ``wd * p``
for adamw, and ``p -= lr * u``. A frozen backbone trains the head alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from port_bench.reference import preprocess
from port_bench.reference.precision import Precision


class Batch(NamedTuple):
    rows: torch.Tensor       # [B] arena rows
    labels: torch.Tensor     # [B] int64
    valid: torch.Tensor      # [B] bool


class Trained(NamedTuple):
    losses: list[float]              # one per step
    first_grads: dict                # name -> the first step's gradient
    params: dict                     # name -> value after the last step
    inputs: torch.Tensor             # the first step's model input


def masked_nll(log_probs: torch.Tensor, batch: Batch,
               class_weights: torch.Tensor | None) -> torch.Tensor:
    picked = log_probs.gather(1, batch.labels[:, None])[:, 0]
    w = batch.valid.float()
    if class_weights is not None:
        w = w * class_weights[batch.labels]
    return -(w * picked).sum() / w.sum().clamp_min(1.0)


def trainable(names, statistic, freeze_backbone: bool) -> list[str]:
    """The names the optimizer updates."""
    return [n for n in names if not statistic(n)
            and (not freeze_backbone or n.startswith("head."))]


def train_steps(model, cfg: dict, params: dict, arena: torch.Tensor,
                batches: list[Batch], draws: list, class_weights,
                optim: dict, prec: Precision) -> Trained:
    """Run ``len(batches)`` steps from ``params`` with each step's
    ``draws`` (``preprocess.StepDraws``). ``model`` is a reference module
    (``flagship``, ``resnet``)."""
    statistic = getattr(model, "is_statistic", lambda n: False)
    names = trainable(params, statistic, cfg.get("freeze_backbone", False))
    p = {k: v.clone() for k, v in params.items()}
    mu = {n: torch.zeros_like(p[n]) for n in names}
    nu = {n: torch.zeros_like(p[n]) for n in names}
    b1, b2, eps = optim["b1"], optim["b2"], optim["eps"]
    lr, wd = optim["learning_rate"], optim.get("weight_decay", 0.0)
    losses, first_grads, first_input = [], {}, None
    for t, (batch, d) in enumerate(zip(batches, draws), start=1):
        x = prec.output(preprocess.train_batch(
            arena, batch.rows, d, cfg["image_size"],
            cfg["normalize_imagenet"]))
        if first_input is None:
            first_input = x.detach()
        leaves = {n: p[n].detach().requires_grad_(True) for n in names}
        lp, stats = model.forward(cfg, {**p, **leaves}, x, d.noise, prec,
                                  train=True)
        loss = masked_nll(lp, batch, class_weights)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        losses.append(float(loss.detach()))
        if t == 1:
            first_grads = {n: g.detach() for n, g in zip(names, grads)}
        with torch.no_grad():
            for n, g in zip(names, grads):
                mu[n] = prec.moment(b1 * mu[n] + (1 - b1) * g)
                nu[n] = prec.moment(b2 * nu[n] + (1 - b2) * g * g)
                u = (mu[n] / (1 - b1 ** t)) / (
                    torch.sqrt(nu[n] / (1 - b2 ** t)) + eps)
                if wd:
                    u = u + wd * p[n]
                p[n] = p[n] - lr * u
            if stats:
                p.update(model.moved_statistics(p, stats,
                                                cfg["bn_momentum"]))
        del lp, loss, grads, leaves
    return Trained(losses, first_grads, p, first_input)


@torch.no_grad()
def eval_log_probs(model, cfg: dict, params: dict, arena: torch.Tensor,
                   n_rows: int, block: int, prec: Precision) -> torch.Tensor:
    """Eval-mode float32 log-probs of arena rows ``[0, n_rows)``, in
    blocks of ``block`` rows. The eval input is float32 and the model's
    first operand rounding covers its precision."""
    out = []
    for lo in range(0, n_rows, block):
        rows = torch.arange(lo, min(lo + block, n_rows), device=arena.device)
        x = preprocess.eval_batch(arena, rows, cfg["image_size"],
                                  cfg["normalize_imagenet"])
        out.append(model.forward(cfg, params, x, None, prec,
                                 train=False)[0])
    return torch.cat(out)

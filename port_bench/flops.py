"""Contraction FLOPs per image, counted by ``torch.utils.flop_counter.
FlopCounterMode`` over the benchmark's plain reference on ``meta``
tensors at the cell's batch and shapes: the forward alone for an audited
image; forward and backward for a trained one, with only the gradients a
step needs (no input gradient of the first conv, no backbone backward
when it is frozen). The count follows the model's published operations,
not how the program lowers them."""

from __future__ import annotations

import torch

from port_bench.reference.train import Batch, masked_nll, trainable


def per_image(mod, cfg: dict, batch: int, train: bool) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    shapes = mod.shapes(cfg)
    params = {n: torch.empty(s, device=meta) for n, s in shapes.items()}
    t = cfg["image_size"]
    x = torch.empty((batch, t, t, cfg["in_channels"]), device=meta)
    with FlopCounterMode(display=False) as counter:
        if not train:
            with torch.no_grad():
                mod.forward(cfg, params, x, None, train=False)
        else:
            stat = getattr(mod, "is_statistic", lambda n: False)
            names = trainable(params, stat, cfg.get("freeze_backbone", False))
            for n in names:
                params[n].requires_grad_(True)
            noise = [torch.empty((batch, w), device=meta)
                     for w in mod.dropout_widths(cfg)]
            lp, _ = mod.forward(cfg, params, x, noise, train=True)
            rows = Batch(None, torch.zeros(batch, dtype=torch.long,
                                           device=meta),
                         torch.ones(batch, dtype=torch.bool, device=meta))
            loss = masked_nll(lp, rows, None)
            torch.autograd.grad(loss, [params[n] for n in names])
    return counter.get_total_flops() / batch

"""The depthwise convolutions' bound: the least device time of a traced
epoch's depthwise convs, from the bytes they must move over the memory
peak (at under 5 operations a byte, bytes decide it).

The layers are the reference's: each convolution whose groups equal its
input channels and whose weight has one input channel a group, recorded
from a forward of one image on ``meta`` tensors at the cell's input size.
Each tensor's bytes count once, at the compute dtype: a forward reads x
and writes y; a trained image adds the input gradient (dy read, dx
written) and the weight gradient (x and dy read). The weights count once
a batch: a forward reads them; a train step reads them twice and writes
their gradient once.

The harness's run carries no cell sizes, so the cell's driver leaves its
:class:`Bound` here at set-up, in :data:`left`; the metric that reads it
(``depthwise_roofline``) finds None in a run whose driver left none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the kernel group of ``port_bench.trace.kernel_group`` that the
#: depthwise convs' kernels fall in
GROUP = "depthwise convolution"


class _Depthwise(TorchDispatchMode):
    """Records ``(C, H, W, H_out, W_out, weight elements)`` of each
    depthwise convolution of one image."""

    def __init__(self):
        super().__init__()
        self.layers: list[tuple[int, ...]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten.convolution.default:
            x, w, groups = args[0], args[1], args[8]
            if groups > 1 and groups == x.shape[1] and w.shape[1] == 1:
                self.layers.append((x.shape[1], *x.shape[2:],
                                    *out.shape[2:], w.numel()))
        return out


def layers(mod, cfg: dict) -> list[tuple[int, ...]]:
    """``(C, H, W, H_out, W_out, weight elements)`` of each depthwise conv
    of reference module ``mod`` at ``cfg``'s input size, in forward
    order."""
    meta = torch.device("meta")
    params = {n: torch.empty(s, device=meta)
              for n, s in mod.shapes(cfg).items()}
    t = cfg["image_size"]
    x = torch.empty((1, t, t, cfg["in_channels"]), device=meta)
    rec = _Depthwise()
    with torch.no_grad(), rec:
        mod.forward(cfg, params, x, None, train=False)
    return rec.layers


class Bound(NamedTuple):
    """Device-memory bytes of the depthwise convs."""

    train_image: int      # a trained image: forward, dx and dW
    eval_image: int       # an audited image: the forward
    train_weights: int    # a train step's weights and weight gradient
    eval_weights: int     # an audit batch's weights
    batch: int            # rows of a train step and of an audit batch

    def epoch_bytes(self, steps: int, audits: int, audit_rows: int) -> int:
        """Bytes of ``steps`` live train steps and ``audits`` audits of
        ``audit_rows`` rows each."""
        batches = -(-audit_rows // self.batch)
        return (steps * (self.batch * self.train_image + self.train_weights)
                + audits * (audit_rows * self.eval_image
                            + batches * self.eval_weights))


def bound(mod, cfg: dict, batch: int, elem_bytes: int) -> Bound:
    """The :class:`Bound` of reference module ``mod`` at ``cfg`` with
    activations and weights of ``elem_bytes``."""
    convs = layers(mod, cfg)
    acts = sum(c * (h * w + ho * wo) for c, h, w, ho, wo, _ in convs)
    weights = sum(n for *_, n in convs)
    return Bound(3 * acts * elem_bytes, acts * elem_bytes,
                 3 * weights * elem_bytes, weights * elem_bytes, batch)


#: the bound the running cell's driver left at set-up, or None
left: Bound | None = None

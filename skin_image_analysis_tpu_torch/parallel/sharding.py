"""Sharding rules (port of the JAX package's ``parallel.sharding``): the
batch over the data axis, the big Dense kernels over the model axis.

A :class:`NamedSharding` names, for each dimension of a tensor, the mesh
axis it is split over (or None), as a JAX ``PartitionSpec`` does. The
port's Dense weight is ``[out, in]``, the transpose of the JAX package's
``[in, out]`` kernel, so the same rule gives the reversed spec:
column-parallel (output features split) is ``(model, None)`` here and
``P(None, model)`` there. ``parallel.tensor`` applies the specs.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

# Dense kernels smaller than this stay replicated even when TP is on.
_TP_MIN_KERNEL_ELEMS = 1 << 20


class NamedSharding(NamedTuple):
    mesh: object
    spec: tuple = ()


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh, data_axis: str = "data") -> NamedSharding:
    """Shard the leading (batch) dim over the data axis; replicate the rest."""
    return NamedSharding(mesh, (data_axis,))


def infer_param_shardings(
    params: Mapping[str, torch.Tensor], mesh, model_axis: str = "model"
) -> dict[str, NamedSharding]:
    """Sharding of each named parameter (a ``state_dict`` or
    ``dict(model.named_parameters())``), in order.

    Default: fully replicated (pure DP). When the mesh has a model axis of
    size > 1, the Dense kernels of at least ``1 << 20`` elements are
    alternately column- and row-parallel, the JAX package's rule: the
    first such kernel splits its output features (when the axis divides
    them), the next its input features, and so on. The flagship's
    100352 x 512 flatten kernel is the one that qualifies; at 224² its
    512 x 256 successor (131,072 elements) stays replicated."""
    n_model = mesh.shape.get(model_axis, 1)
    tp = n_model > 1
    out = {}
    col_next = True
    for name, leaf in params.items():
        spec = ()
        if tp and leaf.dim() == 2 and leaf.numel() >= _TP_MIN_KERNEL_ELEMS:
            n_out, n_in = leaf.shape
            if col_next and n_out % n_model == 0:
                spec = (model_axis, None)
                col_next = False
            elif (not col_next) and n_in % n_model == 0:
                spec = (None, model_axis)
                col_next = True
        out[name] = NamedSharding(mesh, spec)
    return out

"""Tensor parallelism of the big Dense kernels over a process mesh's model
axis: the collectives that the JAX package's compiler inserts from the
specs of :func:`~.sharding.infer_param_shardings`, written out.

A column-parallel Dense holds the rows ``[lo, hi)`` of its ``[out, in]``
weight (its output features) and the whole bias. Its forward takes the
replicated input through Megatron's *f* (identity; the backward sums the
input's gradient over the model axis, since each rank's product covers
only its features), multiplies by its shard, adds its slice of the bias
(whose gradient is summed back into the whole bias), and the model then
runs ReLU and dropout on the feature shard. Unless a row-parallel Dense
follows, the ``[B, out]`` activation is then gathered: each rank writes
its columns into a zero-filled buffer and one ``all_reduce`` sums them
(an ``all_gather`` would do, but gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` only, so this form runs under NCCL and
gloo alike). A row-parallel Dense holds the columns of its weight (its
input features), takes the feature shard, and sums its partial products
over the model axis before the replicated bias.

:func:`shard_train_state` splits a train state's model and optimizer
state in place; :func:`full_state_dict` and :func:`full_train_state`
gather them back (collectives: every rank calls them), so that what a
rank saves has the single-process layout.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F
from torch import nn

from skin_image_analysis_tpu_torch.parallel.sharding import (
    infer_param_shardings,
)


def _sum_over(mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """A float32 copy of ``t`` summed over ``axis``, in ``t``'s dtype."""
    out = t.float().clone()
    mesh.all_reduce(out, axis)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward, gradient summed over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(ctx.mesh, ctx.axis, g), None, None


class _SliceSummedGrad(torch.autograd.Function):
    """``b[lo:hi]``; the whole ``b``'s gradient is summed over the axis,
    so every rank holds the gradient of every feature."""

    @staticmethod
    def forward(ctx, b, lo, hi, mesh, axis):
        ctx.n, ctx.lo, ctx.hi, ctx.mesh, ctx.axis = (b.shape[0], lo, hi,
                                                     mesh, axis)
        return b[lo:hi].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.n)
        full[ctx.lo:ctx.hi] = g
        return _sum_over(ctx.mesh, ctx.axis, full), None, None, None, None


class _GatherColumns(torch.autograd.Function):
    """``[B, w]`` column shards -> ``[B, w * size]`` on every rank; the
    backward keeps this rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, index, size):
        b, w = x.shape
        ctx.lo, ctx.hi = index * w, (index + 1) * w
        full = x.new_zeros((b, w * size))
        full[:, ctx.lo:ctx.hi] = x
        mesh.all_reduce(full, axis)
        return full

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.lo:ctx.hi].contiguous(), None, None, None, None


class _SumOver(torch.autograd.Function):
    """Partial products summed over the axis; the gradient passes as is
    (every rank's downstream is the same)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _sum_over(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceSum(torch.autograd.Function):
    """A sum over the axis whose gradient is summed over it too: each
    rank's contribution reaches every rank's downstream, so its gradient
    is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        out = x.clone()
        mesh.all_reduce(out, axis)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        ctx.mesh.all_reduce(g, ctx.axis)
        return g, None, None


def all_reduce_sum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` summed over ``axis`` of the process ``mesh``, differentiably
    (the data-parallel BatchNorm's statistics). A collective: every rank
    of the axis calls it, forward and backward."""
    return _AllReduceSum.apply(t, mesh, axis)


class TensorParallel:
    """The split of one Dense over ``axis`` of ``mesh``: ``kind`` "col"
    (output features) or "row" (input features)."""

    def __init__(self, kind: str, mesh, axis: str):
        self.kind, self.mesh, self.axis = kind, mesh, axis
        self.index = mesh.axis_index(axis)
        self.size = mesh.shape[axis]

    def _span(self, n: int) -> tuple[int, int]:
        w = n // self.size
        return self.index * w, (self.index + 1) * w

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
        if self.kind == "col":
            x = _CopyToModel.apply(x, self.mesh, self.axis)
            lo, hi = self._span(b.shape[0])
            bias = _SliceSummedGrad.apply(b, lo, hi, self.mesh, self.axis)
            return F.linear(x, w, bias)
        y = _SumOver.apply(F.linear(x, w), self.mesh, self.axis)
        return y + b

    def columns(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's output columns of a ``[B, out]`` tensor (the
        dropout noise of a column-parallel Dense)."""
        if self.kind != "col":
            return t
        lo, hi = self._span(t.shape[1])
        return t[:, lo:hi]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherColumns.apply(x, self.mesh, self.axis, self.index,
                                    self.size)


def _split(t: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    return t.detach().chunk(size, dim=dim)[index].clone()


def tp_layers(model: nn.Module) -> dict[str, TensorParallel]:
    """The split Dense layers of ``model`` by module name."""
    return {name: m.tp for name, m in model.named_modules()
            if getattr(m, "tp", None) is not None}


def shard_train_state(state, mesh, model_axis: str = "model") -> dict:
    """Split the kernels that :func:`infer_param_shardings` puts on the
    model axis, in place: the model's weight becomes this rank's shard
    (a new Parameter, also in the optimizer's list) and so do the
    optimizer's tensors of it (adam's moments, sgd's trace). Returns the
    specs. A split of anything but a Dense weight raises
    NotImplementedError."""
    model, opt = state.model, state.optimizer
    specs = infer_param_shardings(dict(model.named_parameters()), mesh,
                                  model_axis)
    slot = {id(p): i for i, p in enumerate(opt.params)}
    opt_state = opt.state()
    for name, sharding in specs.items():
        if not sharding.spec:
            continue
        module_name, _, pname = name.rpartition(".")
        layer = model.get_submodule(module_name)
        if pname != "weight" or not hasattr(layer, "tp"):
            raise NotImplementedError(
                f"tensor parallelism splits Dense weights only, not {name}")
        kind = "col" if sharding.spec[0] == model_axis else "row"
        tp = TensorParallel(kind, mesh, model_axis)
        dim = 0 if kind == "col" else 1
        old = layer.weight
        new = nn.Parameter(_split(old, dim, tp.index, tp.size),
                           requires_grad=old.requires_grad)
        layer.weight = new
        layer.tp = tp
        i = slot.get(id(old))
        if i is not None:
            opt.params[i] = new
            for tensors in opt_state.values():
                tensors[i] = _split(tensors[i], dim, tp.index, tp.size)
    return specs


def _gather_dim(mesh, tp: TensorParallel, t: torch.Tensor) -> torch.Tensor:
    """The whole tensor from this rank's shard ``t`` of a ``tp`` weight
    (rows for "col", columns for "row")."""
    dim = 0 if tp.kind == "col" else 1
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * tp.size
    full = t.new_zeros(shape)
    full.narrow(dim, tp.index * n, n).copy_(t)
    mesh.all_reduce(full, tp.axis)
    return full


def full_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split weight gathered whole (a
    collective over the model axis)."""
    layers = tp_layers(model)
    out = {}
    for name, t in model.state_dict().items():
        module_name, _, pname = name.rpartition(".")
        tp = layers.get(module_name)
        out[name] = (_gather_dim(tp.mesh, tp, t)
                     if tp is not None and pname == "weight" else t)
    return out


def full_train_state(state):
    """A stand-in of ``state`` with the split weights and their optimizer
    tensors gathered whole, for ``checkpoint.save_train_state`` and
    ``save_model`` (a collective over the model axis)."""
    model, opt = state.model, state.optimizer
    layers = tp_layers(model)
    if not layers:
        return state
    sd = full_state_dict(model)
    tp_of = {}
    for module_name, tp in layers.items():
        tp_of[id(model.get_submodule(module_name).weight)] = tp
    opt_state = {}
    for key, tensors in opt.state().items():
        opt_state[key] = [
            _gather_dim(tp_of[id(p)].mesh, tp_of[id(p)], t)
            if id(p) in tp_of else t
            for p, t in zip(opt.params, tensors)]
    view_model = types.SimpleNamespace(state_dict=lambda: sd)
    view_opt = types.SimpleNamespace(name=opt.name, count=opt.count,
                                     state=lambda: opt_state)
    return types.SimpleNamespace(model=view_model, optimizer=view_opt,
                                 generator=state.generator, step=state.step)

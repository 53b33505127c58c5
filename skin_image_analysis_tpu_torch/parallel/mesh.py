"""Device meshes (port of the JAX package's ``parallel.mesh``).

A :class:`Mesh` lays devices out as ``(data, model)``: the data axis is
data parallelism (each position trains its rows of every global batch,
the gradients summed over the axis), the model axis tensor parallelism
(the big flatten Dense split over it, ``parallel.tensor``). It comes in
two forms:

- a **process mesh** over the ranks of the ``torch.distributed`` world,
  one process per card, the PyTorch idiom for training: each rank holds
  one process group per axis (the ranks it shares that axis with) and
  computes on its own device;
- an **in-process mesh** over a list of local devices (repeats allowed:
  ``[cuda:0, cuda:0]`` runs the split-and-merge code on one card), which
  serving and the HPO waves use, as the JAX package's serve and optuna
  CLIs build theirs from ``jax.devices()[:n]``.

Collectives are explicit here (``torch.distributed``), where the JAX
package's compiler inserts them from sharding annotations.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from skin_image_analysis_tpu_torch.config import MeshConfig
from skin_image_analysis_tpu_torch.parallel import distributed as dist_lib


class Mesh:
    """``devices``: a ``[data, model]`` array of ``torch.device`` (an
    in-process mesh) or of ranks (a process mesh, with ``groups``, this
    rank's ``coords`` on each axis and its ``device``). ``shape`` maps each
    axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices: np.ndarray, axis_names, groups=None,
                 coords=None, device=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))
        self.groups = groups
        self._coords = coords or {}
        self.device = (torch.device(device) if device is not None
                       else devices.flat[0])

    @property
    def is_process_mesh(self) -> bool:
        return self.groups is not None

    @property
    def local_devices(self) -> list[torch.device]:
        """The devices of an in-process mesh, data-major; this rank's one
        of a process mesh."""
        if self.is_process_mesh:
            return [self.device]
        return list(self.devices.flat)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` of an in-process mesh (the first
        position of every other axis)."""
        along = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(along.reshape(along.shape[0], -1)[:, 0])

    def axis_index(self, axis: str) -> int:
        """This rank's position on ``axis`` (0 for an in-process mesh)."""
        return self._coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's ``axis`` (None in-process)."""
        return None if self.groups is None else self.groups[axis]

    def all_reduce(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``tensor`` in place over this rank's ``axis`` group and
        return it. A collective: every rank of the group calls it."""
        dist.all_reduce(tensor, group=self.group(axis))
        return tensor

    def __repr__(self) -> str:
        kind = "process" if self.is_process_mesh else "in-process"
        return f"Mesh({kind}, {dict(self.shape)})"


def _axis_groups(ranks: np.ndarray, axis_names, world: int) -> dict:
    """This rank's group on each axis. Every rank creates every group, in
    the same order (``new_group`` is collective); an axis that spans the
    world uses the world group."""
    me = dist.get_rank()
    mine = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
        for line in lines:
            members = [int(r) for r in line]
            if len(members) == world:
                group = dist.group.WORLD
            else:
                group = dist.new_group(members)
            if me in members:
                mine[name] = group
    return mine


def create_mesh(cfg: MeshConfig = MeshConfig(), devices=None) -> Mesh:
    """Build a ``(data, model)`` mesh over the world's ranks (under a
    process group), or over ``devices``, or, in a single process without
    them, over the current card (RuntimeError without one: pass
    ``devices=["cpu"]`` for the CPU).

    ``data_parallel == -1`` means "every device not claimed by the model
    axis"; a layout that does not cover the devices raises ValueError."""
    process = devices is None and dist.is_initialized()
    if process:
        entries = list(range(dist.get_world_size()))
    elif devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=['cpu'] for a "
                               "mesh on the CPU")
        entries = [torch.device("cuda", torch.cuda.current_device())]
    else:
        entries = [torch.device(d) for d in devices]
    n = len(entries)
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel
    if dp == -1:
        if n % mp:
            raise ValueError(
                f"{n} devices not divisible by model_parallel={mp}")
        dp = n // mp
    if dp * mp != n:
        raise ValueError(
            f"mesh {dp}x{mp} does not cover {n} devices; "
            "set data_parallel=-1 to auto-fill"
        )
    axis_names = (cfg.data_axis, cfg.model_axis)
    arr = np.empty(n, dtype=object)
    arr[:] = entries
    arr = arr.reshape(dp, mp)
    if not process:
        return Mesh(arr, axis_names)
    ranks = arr.astype(np.int64)
    me = dist.get_rank()
    d, m = (int(i[0]) for i in np.nonzero(ranks == me))
    groups = _axis_groups(ranks, axis_names, n)
    return Mesh(arr, axis_names, groups=groups,
                coords={cfg.data_axis: d, cfg.model_axis: m},
                device=dist_lib.local_device())

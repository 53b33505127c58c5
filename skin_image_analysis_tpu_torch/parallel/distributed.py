"""Multi-process initialization and data sharding (port of the JAX
package's ``parallel.distributed``).

The port scales out the PyTorch way: one process per card, joined by
``torch.distributed``. Where the JAX package's ``jax.distributed`` makes
``jax.devices()`` span the cluster, here the process group is the world,
and :func:`~skin_image_analysis_tpu_torch.parallel.mesh.create_mesh` lays
its ranks out as a ``(data, model)`` mesh.

- :func:`maybe_initialize`: call once at CLI start-up. A no-op in a
  single process; joins the group from ``SIA_COORDINATOR`` /
  ``SIA_NUM_PROCESSES`` / ``SIA_PROCESS_ID``, or from the variables
  ``torchrun`` sets (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``), which
  stand where the JAX package reads ``JAX_COORDINATOR_ADDRESS``. NCCL on
  a card (each rank binds ``cuda:LOCAL_RANK``), gloo on the CPU.
- :func:`process_shard`: the contiguous row range this process owns.
- :func:`global_batch`: the global batch, on every rank, from each
  rank's rows of it.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

_initialized = False
_device: torch.device | None = None


def _bind_device(device, rank: int) -> torch.device:
    """The device this rank computes on: ``device`` as given when it names
    an index, else ``cuda:LOCAL_RANK`` on a card (the rank modulo the
    card count where the launcher sets no ``LOCAL_RANK``)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else rank % max(torch.cuda.device_count(), 1))
        dev = torch.device("cuda", index)
    torch.cuda.set_device(dev)
    return dev


def maybe_initialize(device="cuda", backend: str | None = None) -> bool:
    """Join the process group when a multi-process launch is detected;
    returns True when running multi-process (also on a second call).

    Detection, in priority order:

    1. ``SIA_COORDINATOR`` (``host:port``, with ``SIA_NUM_PROCESSES`` and
       ``SIA_PROCESS_ID``): explicit, launcher-agnostic;
    2. ``MASTER_ADDR`` with ``RANK`` and ``WORLD_SIZE`` (``torchrun``).

    ``backend`` defaults to ``nccl`` for a CUDA ``device`` and ``gloo``
    for the CPU; gloo on a card is what two ranks sharing one card need
    (NCCL refuses two ranks on one device)."""
    global _initialized, _device
    if _initialized or dist.is_initialized():
        _initialized = True
        return True
    if os.environ.get("SIA_COORDINATOR"):
        missing = [v for v in ("SIA_NUM_PROCESSES", "SIA_PROCESS_ID")
                   if not os.environ.get(v)]
        if missing:
            raise ValueError(
                f"SIA_COORDINATOR is set but {', '.join(missing)} "
                "is/are not — the three variables configure one cluster "
                "and must be set together (see README.md)")
        init_method = f"tcp://{os.environ['SIA_COORDINATOR']}"
        world = int(os.environ["SIA_NUM_PROCESSES"])
        rank = int(os.environ["SIA_PROCESS_ID"])
    elif all(os.environ.get(v) for v in ("MASTER_ADDR", "RANK",
                                         "WORLD_SIZE")):
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        return False
    dev = _bind_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    _initialized, _device = True, dev
    return True


def local_device() -> torch.device:
    """The device this rank computes on: the one :func:`maybe_initialize`
    bound; else, under a group joined some other way, ``cuda:LOCAL_RANK``
    (the rank modulo the card count without it) when there is a card,
    and the CPU only for a gloo group on a machine without one."""
    if _device is not None:
        return _device
    if not dist.is_initialized():
        raise RuntimeError("no process group: local_device is the device "
                           "of a rank")
    if torch.cuda.is_available():
        return _bind_device("cuda", dist.get_rank())
    if dist.get_backend() == "nccl":
        raise RuntimeError("an NCCL group on a machine without a card")
    return torch.device("cpu")


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_shard(n_rows: int) -> tuple[int, int]:
    """[start, end) of the cohort rows this process loads.

    Contiguous equal-ish split (the first ``n_rows % p`` processes take one
    extra row): for decode and cache ownership, where uneven shards are
    fine. Per-step batches through :func:`global_batch` need equal local
    row counts on every rank: pad a cohort tail with ``valid=False`` rows.
    Single process: the whole range."""
    p, i = process_count(), process_index()
    base, extra = divmod(n_rows, p)
    start = i * base + min(i, extra)
    return start, start + base + (1 if i < extra else 0)


def gather_rows(mesh, axis: str, t: torch.Tensor, n: int,
                lo: int) -> torch.Tensor:
    """The ``n``-row tensor whose rows ``[lo, lo + len(t))`` are this
    rank's ``t``, whole on every rank of the ``axis`` group: a
    zero-filled buffer summed over the axis (exact; a collective that
    gloo also runs on CUDA tensors)."""
    if mesh.shape[axis] == 1:
        return t
    wire = t.to(torch.uint8) if t.dtype == torch.bool else t
    full = wire.new_zeros((n, *t.shape[1:]))
    full[lo:lo + t.shape[0]] = wire
    return mesh.all_reduce(full, axis).to(t.dtype)


def global_batch(mesh, local: dict, data_axis: str = "data",
                 device=None) -> dict:
    """The global batch from each rank's local rows (the JAX package's
    global array). Every rank passes its own ``local`` arrays (host numpy
    or tensors, leading dim = global batch / data-axis size, the same on
    every rank; the ranks of one model-axis group pass the same rows) and
    gets the whole batch on ``device`` (the mesh's), the ranks' rows in
    data-axis order. The train and eval steps take it and run this
    rank's rows of it."""
    rows = {k: int(tuple(v.shape if torch.is_tensor(v) else np.shape(v))[0])
            if (v.dim() if torch.is_tensor(v) else np.ndim(v)) else -1
            for k, v in local.items()}
    if len(set(rows.values())) > 1:
        raise ValueError(
            f"global_batch needs one row count across all arrays, got "
            f"{rows} — pad uneven tails with valid=False rows instead"
        )
    n = next(iter(rows.values()), 0)
    dev = torch.device(device) if device is not None else mesh.device
    dp = mesh.shape[data_axis]
    lo = n * mesh.axis_index(data_axis)
    return {k: gather_rows(mesh, data_axis, torch.as_tensor(v).to(dev),
                           n * dp, lo)
            for k, v in local.items()}


def process_info() -> dict:
    """This process's place in the world: one card (or the CPU) a
    process, so the global devices are the world's processes."""
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices": 1,
        "global_devices": process_count(),
    }

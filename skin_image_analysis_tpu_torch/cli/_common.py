"""Shared positional and flag parsing for the port's CLIs (port of the
JAX package's ``cli._common``).

The CLIs take the reference's positionals plus optional ``--flag value``
or ``--flag=value`` extras; ``parse`` consumes flag values so they never
leak into the positionals.
"""

from __future__ import annotations

import json
import os
from typing import Any

from skin_image_analysis_tpu_torch.ops.preprocess import normalize_affine
from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib


def parse(
    argv: list[str], value_flags: dict[str, Any],
    bool_flags: set[str] = frozenset(),
) -> tuple[list[str], dict[str, Any]]:
    """Returns (positionals, options). ``value_flags`` maps flag name to
    default (its type casts the value); ``bool_flags`` are presence
    flags. An unknown flag exits with an error."""
    positional: list[str] = []
    opts: dict[str, Any] = dict(value_flags)
    flags_seen: set[str] = set()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            name, _, value = arg[2:].partition("=")
            if name in bool_flags:
                flags_seen.add(name)
            elif name in value_flags:
                if not value:
                    i += 1
                    if i >= len(argv):
                        raise SystemExit(f"--{name} requires a value")
                    value = argv[i]
                default = value_flags[name]
                cast = type(default) if default is not None else str
                opts[name] = cast(value)
            else:
                raise SystemExit(f"unknown flag --{name}")
        else:
            positional.append(arg)
        i += 1
    for name in bool_flags:
        opts[name] = name in flags_seen
    return positional, opts


def init_runtime(device="cuda") -> bool:
    """Multi-process set-up: join the ``torch.distributed`` group that a
    launcher (``torchrun``, or the ``SIA_*`` variables) describes
    (``parallel.distributed.maybe_initialize``); a no-op in a single
    process. Returns whether the process is one of a group."""
    from skin_image_analysis_tpu_torch.parallel.distributed import (
        maybe_initialize,
    )

    return maybe_initialize(device=device)


def local_mesh(n: int, device: str):
    """The in-process mesh of ``--mesh n`` (None for ``n <= 1``): the
    first ``n`` cards for a CUDA ``device``, or ``n`` positions on the
    CPU, one data axis."""
    if n <= 1:
        return None
    import torch

    from skin_image_analysis_tpu_torch.config import MeshConfig
    from skin_image_analysis_tpu_torch.parallel.mesh import create_mesh
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if n > len(devices):
            raise SystemExit(
                f"--mesh {n} but only {len(devices)} devices available")
    else:
        devices = ["cpu"] * n
    return create_mesh(MeshConfig(data_parallel=n, model_parallel=1),
                       devices=devices[:n])


def given(argv: list[str]) -> set[str]:
    """The names of the ``--flags`` that ``argv`` sets."""
    return {a[2:].partition("=")[0] for a in argv if a.startswith("--")}


def input_convention(folder: str) -> tuple[bool, tuple | None]:
    """The experiment's model-input convention from its
    ``train_config.json``: ``(normalize_imagenet, input_affine)``;
    ``(False, None)`` (the flagship's) when the folder has none."""
    cfg_path = os.path.join(folder, "train_config.json")
    if not os.path.exists(cfg_path):
        return False, None
    try:
        with open(cfg_path) as f:
            data_cfg = json.load(f).get("data", {})
    except (OSError, ValueError):
        return False, None
    return (
        bool(data_cfg.get("normalize_imagenet", False)),
        normalize_affine(data_cfg.get("input_affine")),
    )


def model_file(folder: str, best: bool = False) -> str:
    """The model artifact of an experiment folder: ``session_model.msgpack``,
    or with ``best`` the keep-best ``session_model_best.msgpack``, which
    must exist."""
    name = ckpt_lib.BEST_MODEL_FILENAME if best else ckpt_lib.MODEL_FILENAME
    path = os.path.join(folder, name)
    if best and not os.path.exists(path):
        raise SystemExit(
            f"{folder} has no session_model_best.msgpack — train with "
            "--keep-best to produce one")
    return path

"""Checkpoints (port of the JAX package's ``train.checkpoint``).

1. ``save_model`` / ``load_model``: the ``session_model`` artifact, the
   same file as the JAX package writes and reads: ``SIAT``, the header
   length (u32 little endian), a JSON header (format 2, the
   ``ModelConfig``) and the msgpack of ``{"params": <Flax tree>}``, or
   ``{"params", "batch_stats"}`` with ``has_batch_stats`` for a model
   with BatchNorm (ResNet). The
   port's ``state_dict`` goes through ``bridge`` both ways, and the
   codec is the port's own (``utils.serialization``), so the same weights
   give the same bytes in both packages. Written atomically.
2. ``save_train_state`` / ``restore_train_state``: full resume (model
   parameters and buffers, the optimizer's name, state and count, step,
   generator state) in the port's own
   format, ``torch.save`` of plain tensors into ``checkpoint/
   train_state.pt``. A ``checkpoint/`` that holds the JAX package's orbax
   snapshot instead is refused: the port cannot read it.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import torch

from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch import config as config_lib
from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.train.state import TrainState
from skin_image_analysis_tpu_torch.utils import serialization

MODEL_FILENAME = "session_model.msgpack"
#: the --keep-best checkpoint
BEST_MODEL_FILENAME = "session_model_best.msgpack"
STATE_FILENAME = "train_state.pt"
_MAGIC = b"SIAT"


def _sorted_tree(tree: Any) -> Any:
    """Keys in sorted order at every level, as ``jax.device_get`` hands
    the JAX package's ``save_model`` its params."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def save_model(path: str, model_cfg: ModelConfig,
               state_dict: dict[str, torch.Tensor]) -> None:
    """Atomic write of [magic | header_len | json header | msgpack
    {"params": ...}] for the port's ``state_dict``; a model with
    BatchNorm writes {"params", "batch_stats"} and ``has_batch_stats``."""
    params, batch_stats = bridge.state_dict_to_variables(
        state_dict, model_cfg.image_size,
        wrap=model_cfg.name == "skin_cancer")
    header = json.dumps({
        "format": 2,
        "model": config_lib.to_dict(model_cfg),
        "has_batch_stats": batch_stats is not None,
    }).encode()
    payload = {"params": _sorted_tree(params)}
    if batch_stats is not None:
        payload["batch_stats"] = _sorted_tree(batch_stats)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        serialization.write(f, payload)
    os.replace(tmp, path)


def split_variables(loaded: Any) -> tuple[Any, Any]:
    """(params, batch_stats_or_None) from a restored model payload."""
    if isinstance(loaded, dict) and set(loaded) <= {"params", "batch_stats"} \
            and "params" in loaded and (
                "batch_stats" in loaded or len(loaded) == 1):
        return loaded["params"], loaded.get("batch_stats")
    return loaded, None


def load_model(path: str) -> tuple[ModelConfig, dict[str, torch.Tensor]]:
    """``(model_cfg, state_dict)`` from a ``session_model`` file of either
    package; for a model with BatchNorm the state_dict holds its running
    statistics too. A file whose header or body does not parse, or whose
    batch statistics do not fit the model, raises ValueError."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not a session_model file")
        try:
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen))
            blob = f.read()
        except (struct.error, UnicodeDecodeError, ValueError) as e:
            raise ValueError(
                f"{path}: corrupt session_model header: {e}") from e
    try:
        model_cfg = config_lib._build(ModelConfig, header["model"])
        restored = serialization.msgpack_restore(blob)
        if header.get("format", 1) != 1 and not header.get("has_batch_stats"):
            restored = restored["params"]
        params, batch_stats = split_variables(restored)
        state_dict = bridge.variables_to_state_dict(
            params, batch_stats, model_cfg.image_size)
    except Exception as e:
        if isinstance(e, ValueError):
            raise
        raise ValueError(f"{path}: corrupt session_model body: {e}") from e
    return model_cfg, state_dict


def snapshot(state: TrainState) -> dict:
    """Everything ``restore_train_state`` needs: copies on the CPU, and
    ints. The optimizer's part is its name, its count and its
    :meth:`~skin_image_analysis_tpu_torch.train.state.Optimizer.state`
    (adam's and adamw's ``mu``/``nu``, rmsprop's ``nu``, sgd's
    ``trace``)."""
    def copy(t):
        return t.detach().to("cpu", copy=True)

    opt = state.optimizer
    return {
        "step": int(state.step),
        "model": {k: copy(v) for k, v in state.model.state_dict().items()},
        "optimizer": opt.name,
        "opt_count": int(opt.count),
        "opt_state": {k: [copy(t) for t in ts]
                      for k, ts in opt.state().items()},
        "generator": state.generator.get_state(),
    }


def save_train_state(ckpt_dir: str, state: TrainState) -> None:
    """Atomic write of :func:`snapshot` into ``ckpt_dir``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, STATE_FILENAME)
    torch.save(snapshot(state), path + ".tmp")
    os.replace(path + ".tmp", path)


def read_train_state(ckpt_dir: str) -> dict:
    """The snapshot in ``ckpt_dir``. A directory without the port's file
    (the JAX package's orbax snapshot) is refused."""
    path = os.path.join(ckpt_dir, STATE_FILENAME)
    if not os.path.exists(path):
        raise ValueError(
            f"{ckpt_dir} holds no {STATE_FILENAME}: it is not a snapshot of "
            "the port (a folder trained by the JAX package keeps an orbax "
            "snapshot there, which the port cannot read). Resume this "
            "folder with the JAX package, or move the checkpoint directory "
            "away to resume from session_model.msgpack without the "
            "optimizer state")
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(ckpt_dir: str, template: TrainState) -> TrainState:
    """Copy the snapshot in ``ckpt_dir`` into ``template`` (in place,
    bit for bit) and return it. A snapshot of another optimizer, or of
    other shapes or dtypes, raises ValueError."""
    snap = read_train_state(ckpt_dir)
    opt = template.optimizer
    if snap["optimizer"] != opt.name:
        raise ValueError(
            f"{ckpt_dir}: the snapshot holds {snap['optimizer']} state, the "
            f"run trains with {opt.name}")
    mine_state = opt.state()
    if set(snap["opt_state"]) != set(mine_state) or any(
            len(snap["opt_state"][k]) != len(v)
            for k, v in mine_state.items()):
        raise ValueError(
            f"{ckpt_dir}: the snapshot's {opt.name} state "
            f"{ {k: len(v) for k, v in snap['opt_state'].items()} } does "
            f"not fit the model's { {k: len(v) for k, v in mine_state.items()} }")
    template.model.load_state_dict(snap["model"])
    with torch.no_grad():
        for key, tensors in mine_state.items():
            for mine, saved in zip(tensors, snap["opt_state"][key]):
                if mine.shape != saved.shape or mine.dtype != saved.dtype:
                    raise ValueError(
                        f"{ckpt_dir}: {key} of {tuple(saved.shape)} "
                        f"{saved.dtype} where the optimizer keeps "
                        f"{tuple(mine.shape)} {mine.dtype}")
                mine.copy_(saved)
    opt.count = snap["opt_count"]
    template.step = snap["step"]
    template.generator.set_state(snap["generator"])
    return template

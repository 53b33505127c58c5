"""Weight bridge: the JAX package's Flax param tree (as numpy) <-> the
port's ``state_dict``.

Flax names ``ConvBlock_i/Conv_0/{kernel,bias}`` (kernel HWIO),
``MlpBlock_j/Dense_0/{kernel,bias}`` and ``Dense_0`` (kernel ``[in,
out]``); ``SkinCancerModel`` nests all of it under
``SkinCancerListModel_0``. The port's names are ``conv_blocks.i``,
``mlp_blocks.j`` and ``head`` with ``weight`` (OIHW or ``[out, in]``) and
``bias``. The JAX model flattens NHWC and the port NCHW, so the first
dense layer's input rows are permuted; every other step is a transpose,
and a round trip is bit-exact.

The ResNet family carries BatchNorm statistics too: Flax's ``stem_conv``,
``stem_bn``, ``BasicBlock_i`` / ``Bottleneck_i`` (numbered across stages,
each with ``Conv_j`` / ``BatchNorm_j`` and ``downsample_conv`` /
``downsample_bn``) and ``Dense_0`` are the port's ``stem_conv``,
``stem_bn``, ``blocks.i`` (``convj``, ``bnj``, ``downsample_conv``,
``downsample_bn``) and ``head``. A BatchNorm's ``scale`` / ``bias`` are
``weight`` / ``bias``, and its ``batch_stats`` ``mean`` / ``var`` the
buffers ``running_mean`` / ``running_var``.

The Keras-compatible families (Xception, VGG, ResNet-V2, MobileNetV2,
EfficientNet, EfficientNetV2) share their module names with the Flax
models, which are the Keras layer names (``block1_conv1``,
``conv4_block6_preact_bn``, ``block_3_depthwise_BN``, ...), nested where
the Flax modules nest: Xception's ``blockN_sepconvM`` holds
``depthwise`` and ``pointwise``, and EfficientNet's ``block2a`` holds
``block2a_dwconv``, as the port's ``block2a.block2a_dwconv``. Only
``Dense_0`` is the port's ``head``. A depthwise kernel is ``[k, k, 1,
C]`` in Flax and ``[C, 1, k, k]`` here, the same transpose as any conv
kernel; VGG has no BatchNorm, so no batch statistics.
:func:`variables_to_state_dict` and :func:`state_dict_to_variables` pick
the family from the tree.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_WRAP = "SkinCancerListModel_0"


def nhwc_flatten_permutation(c: int, h: int, w: int) -> np.ndarray:
    """For each NHWC-flatten row (h, w, c) the NCHW-flatten index
    c*H*W + h*W + w."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).ravel()


def _first_dense_geometry(n_conv: int, channels: int, image_size: int):
    side = image_size
    for _ in range(n_conv):
        side //= 2
    return channels, side, side


def flax_to_state_dict(
    params: Mapping[str, Any], image_size: int
) -> dict[str, torch.Tensor]:
    """Flax params (nested dicts of arrays) -> the port's state_dict of
    CPU tensors. ``image_size`` fixes the first dense layer's flatten
    geometry."""
    if set(params) == {_WRAP}:
        params = params[_WRAP]
    convs = sorted((k for k in params if k.startswith("ConvBlock_")),
                   key=lambda k: int(k.split("_")[1]))
    mlps = sorted((k for k in params if k.startswith("MlpBlock_")),
                  key=lambda k: int(k.split("_")[1]))
    sd: dict[str, torch.Tensor] = {}
    channels = 0
    for i, name in enumerate(convs):
        p = params[name]["Conv_0"]
        kernel = np.asarray(p["kernel"])
        sd[f"conv_blocks.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        sd[f"conv_blocks.{i}.bias"] = torch.from_numpy(
            np.array(p["bias"]))
        channels = kernel.shape[3]
    for j, name in enumerate(mlps):
        p = params[name]["Dense_0"]
        kernel = np.asarray(p["kernel"])
        if j == 0 and convs:
            c, h, w = _first_dense_geometry(len(convs), channels, image_size)
            if kernel.shape[0] != c * h * w:
                raise ValueError(f"{name} has {kernel.shape[0]} inputs, the "
                                 f"conv stack gives {c}x{h}x{w}")
            rows = np.empty_like(kernel)
            rows[nhwc_flatten_permutation(c, h, w)] = kernel
            kernel = rows
        sd[f"mlp_blocks.{j}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.T))
        sd[f"mlp_blocks.{j}.bias"] = torch.from_numpy(np.array(p["bias"]))
    head = params["Dense_0"]
    sd["head.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(head["kernel"]).T))
    sd["head.bias"] = torch.from_numpy(np.array(head["bias"]))
    return sd


def state_dict_to_flax(
    state_dict: Mapping[str, torch.Tensor], image_size: int,
    wrap: bool = False,
) -> dict[str, Any]:
    """The port's state_dict -> Flax params as nested dicts of numpy
    arrays (``wrap`` nests them as ``SkinCancerModel`` does)."""
    def arr(name):
        return state_dict[name].detach().cpu().numpy()

    n_conv = len({k.split(".")[1] for k in state_dict
                  if k.startswith("conv_blocks.")})
    n_mlp = len({k.split(".")[1] for k in state_dict
                 if k.startswith("mlp_blocks.")})
    params: dict[str, Any] = {}
    channels = 0
    for i in range(n_conv):
        weight = arr(f"conv_blocks.{i}.weight")
        params[f"ConvBlock_{i}"] = {"Conv_0": {
            "kernel": np.ascontiguousarray(weight.transpose(2, 3, 1, 0)),
            "bias": arr(f"conv_blocks.{i}.bias").copy(),
        }}
        channels = weight.shape[0]
    for j in range(n_mlp):
        kernel = np.ascontiguousarray(arr(f"mlp_blocks.{j}.weight").T)
        if j == 0 and n_conv:
            c, h, w = _first_dense_geometry(n_conv, channels, image_size)
            kernel = kernel[nhwc_flatten_permutation(c, h, w)]
        params[f"MlpBlock_{j}"] = {"Dense_0": {
            "kernel": kernel, "bias": arr(f"mlp_blocks.{j}.bias").copy(),
        }}
    params["Dense_0"] = {
        "kernel": np.ascontiguousarray(arr("head.weight").T),
        "bias": arr("head.bias").copy(),
    }
    return {_WRAP: params} if wrap else params


_BN_PARAMS = (("scale", "weight"), ("bias", "bias"))
_BN_STATS = (("mean", "running_mean"), ("var", "running_var"))


def _conv_to_torch(kernel) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(kernel).transpose(3, 2, 0, 1)))


def _index_sorted(names, prefix: str) -> list[str]:
    return sorted((k for k in names if k.startswith(prefix)),
                  key=lambda k: int(k.rsplit("_", 1)[1]))


def _head_to_torch(head: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    return {"head.weight": torch.from_numpy(
                np.ascontiguousarray(np.asarray(head["kernel"]).T)),
            "head.bias": torch.from_numpy(np.array(head["bias"]))}


def resnet_to_state_dict(params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any] | None
                         ) -> dict[str, torch.Tensor]:
    """A Flax ResNet's params and batch_stats -> the port's state_dict
    (parameters and buffers) of CPU tensors."""
    sd: dict[str, torch.Tensor] = {}
    stats = batch_stats or {}

    def bn(port: str, p: Mapping, s: Mapping | None) -> None:
        for flax_name, name in _BN_PARAMS:
            sd[f"{port}.{name}"] = torch.from_numpy(np.array(p[flax_name]))
        if s is not None:
            for flax_name, name in _BN_STATS:
                sd[f"{port}.{name}"] = torch.from_numpy(
                    np.array(s[flax_name]))

    sd["stem_conv.weight"] = _conv_to_torch(params["stem_conv"]["kernel"])
    bn("stem_bn", params["stem_bn"], stats.get("stem_bn"))
    blocks = (_index_sorted(params, "BasicBlock_")
              or _index_sorted(params, "Bottleneck_"))
    for i, name in enumerate(blocks):
        p, s = params[name], stats.get(name, {})
        for j, conv in enumerate(_index_sorted(p, "Conv_")):
            sd[f"blocks.{i}.conv{j}.weight"] = _conv_to_torch(
                p[conv]["kernel"])
            bn(f"blocks.{i}.bn{j}", p[f"BatchNorm_{j}"],
               s.get(f"BatchNorm_{j}"))
        if "downsample_conv" in p:
            sd[f"blocks.{i}.downsample_conv.weight"] = _conv_to_torch(
                p["downsample_conv"]["kernel"])
            bn(f"blocks.{i}.downsample_bn", p["downsample_bn"],
               s.get("downsample_bn"))
    sd.update(_head_to_torch(params["Dense_0"]))
    return sd


def resnet_to_flax(state_dict: Mapping[str, torch.Tensor],
                   bottleneck: bool) -> tuple[dict, dict]:
    """The port's ResNet state_dict -> Flax ``(params, batch_stats)`` as
    nested dicts of numpy arrays."""
    def arr(name):
        return state_dict[name].detach().cpu().numpy().copy()

    def conv(name):
        return {"kernel": np.ascontiguousarray(
            arr(name).transpose(2, 3, 1, 0))}

    def bn(port: str, params: dict, stats: dict, flax_name: str) -> None:
        params[flax_name] = {f: arr(f"{port}.{t}") for f, t in _BN_PARAMS}
        stats[flax_name] = {f: arr(f"{port}.{t}") for f, t in _BN_STATS}

    params: dict[str, Any] = {"stem_conv": conv("stem_conv.weight")}
    stats: dict[str, Any] = {}
    bn("stem_bn", params, stats, "stem_bn")
    n_blocks = len({k.split(".")[1] for k in state_dict
                    if k.startswith("blocks.")})
    kind = "Bottleneck" if bottleneck else "BasicBlock"
    for i in range(n_blocks):
        p: dict[str, Any] = {}
        s: dict[str, Any] = {}
        n_convs = len({k.split(".")[2] for k in state_dict
                       if k.startswith(f"blocks.{i}.conv")})
        for j in range(n_convs):
            p[f"Conv_{j}"] = conv(f"blocks.{i}.conv{j}.weight")
            bn(f"blocks.{i}.bn{j}", p, s, f"BatchNorm_{j}")
        if f"blocks.{i}.downsample_conv.weight" in state_dict:
            p["downsample_conv"] = conv(f"blocks.{i}.downsample_conv.weight")
            bn(f"blocks.{i}.downsample_bn", p, s, "downsample_bn")
        params[f"{kind}_{i}"] = p
        stats[f"{kind}_{i}"] = s
    params["Dense_0"] = {
        "kernel": np.ascontiguousarray(arr("head.weight").T),
        "bias": arr("head.bias"),
    }
    return params, stats


def keras_to_state_dict(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any] | None
                        ) -> dict[str, torch.Tensor]:
    """A Keras-compatible family's Flax params and batch_stats -> the
    port's state_dict (parameters and buffers) of CPU tensors. A module
    path ``a/b`` is the port's ``a.b``; ``Dense_0`` is ``head``."""
    sd: dict[str, torch.Tensor] = {}

    def walk(params: Mapping, stats: Mapping, prefix: str) -> None:
        for name, p in params.items():
            port = prefix + name
            if not prefix and name == "Dense_0":
                sd.update(_head_to_torch(p))
            elif "scale" in p:  # a BatchNorm
                for flax_name, t in _BN_PARAMS:
                    sd[f"{port}.{t}"] = torch.from_numpy(
                        np.array(p[flax_name]))
                if name in stats:
                    for flax_name, t in _BN_STATS:
                        sd[f"{port}.{t}"] = torch.from_numpy(
                            np.array(stats[name][flax_name]))
            elif "kernel" in p:
                sd[f"{port}.weight"] = _conv_to_torch(p["kernel"])
                if "bias" in p:
                    sd[f"{port}.bias"] = torch.from_numpy(np.array(p["bias"]))
            else:
                walk(p, stats.get(name, {}), port + ".")

    walk(params, batch_stats or {}, "")
    return sd


def keras_to_flax(state_dict: Mapping[str, torch.Tensor]
                  ) -> tuple[dict, dict | None]:
    """The port's state_dict of a Keras-compatible family -> Flax
    ``(params, batch_stats)`` as nested dicts of numpy arrays;
    ``batch_stats`` is None for a family without BatchNorm (VGG)."""
    def arr(name):
        return state_dict[name].detach().cpu().numpy().copy()

    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    def node(tree: dict, path: list[str]) -> dict:
        for name in path:
            tree = tree.setdefault(name, {})
        return tree

    for module in dict.fromkeys(k.rsplit(".", 1)[0] for k in state_dict):
        path = module.split(".")
        if module == "head":
            params["Dense_0"] = {
                "kernel": np.ascontiguousarray(arr("head.weight").T),
                "bias": arr("head.bias")}
        elif f"{module}.running_mean" in state_dict:
            node(params, path).update(
                {f: arr(f"{module}.{t}") for f, t in _BN_PARAMS})
            node(stats, path).update(
                {f: arr(f"{module}.{t}") for f, t in _BN_STATS})
        else:
            leaf = node(params, path)
            leaf["kernel"] = np.ascontiguousarray(
                arr(f"{module}.weight").transpose(2, 3, 1, 0))
            if f"{module}.bias" in state_dict:
                leaf["bias"] = arr(f"{module}.bias")
    return params, stats or None


def _flagship(names) -> bool:
    return all(k in ("Dense_0", _WRAP) or k.startswith(
        ("ConvBlock_", "MlpBlock_")) for k in names)


def variables_to_state_dict(params: Mapping[str, Any],
                            batch_stats: Mapping[str, Any] | None,
                            image_size: int) -> dict[str, torch.Tensor]:
    """Flax variables of any family -> the port's state_dict. Batch
    statistics for a model without BatchNorm raise ValueError."""
    if "BasicBlock_0" in params or "Bottleneck_0" in params:
        return resnet_to_state_dict(params, batch_stats)
    if not _flagship(params):
        return keras_to_state_dict(params, batch_stats)
    if batch_stats:
        raise ValueError("batch statistics for a model without BatchNorm "
                         f"(top-level params {sorted(params)})")
    return flax_to_state_dict(params, image_size)


def state_dict_to_variables(state_dict: Mapping[str, torch.Tensor],
                            image_size: int, wrap: bool = False
                            ) -> tuple[dict, dict | None]:
    """The port's state_dict of any family -> Flax ``(params,
    batch_stats)``; ``batch_stats`` is None for the flagship models and
    VGG."""
    if "blocks.0.conv0.weight" in state_dict:
        bottleneck = "blocks.0.conv2.weight" in state_dict
        return resnet_to_flax(state_dict, bottleneck)
    if not all(k.startswith(("conv_blocks.", "mlp_blocks.", "head."))
               for k in state_dict):
        return keras_to_flax(state_dict)
    return state_dict_to_flax(state_dict, image_size, wrap), None

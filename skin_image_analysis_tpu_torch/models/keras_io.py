"""Reader of Keras weight files (port of the JAX package's
``models.keras_io``).

Every Keras-compatible backbone maps weights by layer name with the short
per-variable names Keras uses (``kernel``, ``gamma``,
``depthwise_kernel``, ...). :func:`read_legacy_h5` reads that view from
the legacy ``layer_names`` / ``weight_names`` ``.h5`` layout every
downloadable ``*_weights_tf_dim_ordering_tf_kernels*.h5`` file uses, with
h5py only (no TF or Keras at load time). h5py is imported when a file is
read; without it the reader raises an ImportError that names it.
:func:`read_live_model` reads the same view from a loaded Keras model.

:class:`StateDictWriter` puts Keras weights into a copy of the port's
``state_dict`` in the port's layouts: a conv kernel ``[k, k, I, O]`` as
``[O, I, k, k]``, a depthwise kernel ``[k, k, C, 1]`` as ``[C, 1, k, k]``,
a BatchNorm's ``gamma`` / ``beta`` / ``moving_mean`` /
``moving_variance`` as ``weight`` / ``bias`` / ``running_mean`` /
``running_var``. :func:`apply_name_identity_weights` is the mapping of the
families whose modules carry the Keras layer names.
"""

from __future__ import annotations

from typing import Callable, Iterable, Mapping

import numpy as np
import torch

#: short weight names per Keras layer class, in get_weights() order
WEIGHT_NAMES = {
    "Conv2D": ("kernel", "bias"),
    "SeparableConv2D": ("depthwise_kernel", "pointwise_kernel", "bias"),
    "DepthwiseConv2D": ("depthwise_kernel", "bias"),
    "BatchNormalization": ("gamma", "beta", "moving_mean",
                           "moving_variance"),
    "Dense": ("kernel", "bias"),
    # EfficientNet v1 builds Normalization(axis) without constructor
    # stats, so Keras stores them as layer variables; every family's
    # mapping skips the layer by name
    "Normalization": ("mean", "variance", "count"),
}


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading a Keras .h5 weights file needs h5py, which is not "
            "installed") from e
    return h5py


def _names(attr) -> list[str]:
    return [n.decode() if isinstance(n, bytes) else str(n) for n in attr]


def read_legacy_h5(path: str) -> tuple[list[str], dict[str, dict]]:
    """(ordered layer names, {layer: {short_name: ndarray}}) from a
    legacy-format weights ``.h5``; the weights load eagerly."""
    with _h5py().File(path, "r") as f:
        grp = f["model_weights"] if "model_weights" in f else f
        layer_names = _names(grp.attrs["layer_names"])
        table: dict[str, dict] = {}
        for layer in layer_names:
            g = grp[layer]
            table[layer] = {
                n.split("/")[-1].split(":")[0]: np.asarray(g[n])
                for n in _names(g.attrs["weight_names"])
            }
    return layer_names, table


class StateDictWriter:
    """Keras weights into a copy of ``state_dict`` (:attr:`out`). A
    missing target raises KeyError, a shape mismatch ValueError."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor]):
        self.target = state_dict
        self.out = dict(state_dict)

    def put(self, key: str, value) -> None:
        if key not in self.target:
            raise KeyError(f"converter target {key} not in model")
        value = torch.from_numpy(np.ascontiguousarray(value))
        expect = tuple(self.target[key].shape)
        if tuple(value.shape) != expect:
            raise ValueError(f"{key}: {tuple(value.shape)} vs {expect}")
        self.out[key] = value.to(self.target[key].dtype)

    def bn(self, port: str, w: Mapping) -> None:
        for mine, theirs in (("weight", "gamma"), ("bias", "beta"),
                             ("running_mean", "moving_mean"),
                             ("running_var", "moving_variance")):
            self.put(f"{port}.{mine}", w[theirs])

    def conv(self, port: str, w: Mapping) -> None:
        """A Conv2D's ``kernel`` and, where it has one, its ``bias``."""
        self.put(f"{port}.weight", np.transpose(w["kernel"], (3, 2, 0, 1)))
        if "bias" in w:
            self.put(f"{port}.bias", w["bias"])

    def depthwise(self, port: str, kernel) -> None:
        self.put(f"{port}.weight", np.transpose(kernel, (2, 3, 0, 1)))


def apply_name_identity_weights(
    layer_names: Iterable[str], weights_of: Callable[[str], Mapping],
    state_dict: Mapping[str, torch.Tensor], skip: tuple[str, ...] = (),
    module_of: Callable[[str], str] = lambda layer: layer,
) -> dict[str, torch.Tensor]:
    """The Keras -> port mapping of the families whose modules carry the
    Keras layer names (``resnet_v2``, ``mobilenet``, ``efficientnet``,
    ``efficientnet_v2``); ``module_of`` gives a layer's module path where
    the modules nest. ``skip`` lists exact layer names or name prefixes
    to leave out (ImageNet heads, preprocessing layers); weightless
    layers are passed over. Returns the updated copy of ``state_dict``."""
    writer = StateDictWriter(state_dict)
    for layer in layer_names:
        if layer in skip or layer.startswith(tuple(skip)):
            continue
        w = weights_of(layer)
        if not w:
            continue
        port = module_of(layer)
        if "gamma" in w:
            writer.bn(port, w)
        elif "depthwise_kernel" in w and "pointwise_kernel" not in w:
            writer.depthwise(port, w["depthwise_kernel"])
        elif "kernel" in w:
            writer.conv(port, w)
        else:
            raise ValueError(f"{layer}: unrecognized weight set {sorted(w)}")
    return writer.out


def read_live_model(model) -> tuple[list[str], dict[str, dict]]:
    """(ordered weighted-layer names, {layer: {short_name: ndarray}}) from
    a live Keras model (``migrate.keras_model`` loads one with keras). A
    weighted layer of a class no family mapping consumes raises
    ValueError."""
    names: list[str] = []
    table: dict[str, dict] = {}
    for layer in model.layers:
        ws = layer.get_weights()
        if not ws:
            continue
        cls = layer.__class__.__name__
        if cls not in WEIGHT_NAMES:
            raise ValueError(f"layer {layer.name!r}: unsupported weighted "
                             f"layer class {cls}")
        shorts = WEIGHT_NAMES[cls][: len(ws)]
        if len(shorts) != len(ws):
            raise ValueError(
                f"layer {layer.name!r} ({cls}): {len(ws)} weights, "
                f"expected at most {len(WEIGHT_NAMES[cls])}")
        if layer.name in table:
            raise ValueError(f"duplicate layer name {layer.name!r}")
        names.append(layer.name)
        table[layer.name] = {s: np.asarray(w) for s, w in zip(shorts, ws)}
    return names, table

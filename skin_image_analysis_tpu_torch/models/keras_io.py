"""Reader of Keras weight files (port of the JAX package's
``models.keras_io``).

Every Keras-compatible backbone maps weights by layer name with the short
per-variable names Keras uses (``kernel``, ``gamma``,
``depthwise_kernel``, ...). :func:`read_legacy_h5` reads that view from
the legacy ``layer_names`` / ``weight_names`` ``.h5`` layout every
downloadable ``*_weights_tf_dim_ordering_tf_kernels*.h5`` file uses, with
h5py only (no TF or Keras at load time). h5py is imported when a file is
read; without it the reader raises an ImportError that names it.
"""

from __future__ import annotations

import numpy as np

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

"""Model registry: name -> constructor taking a ``ModelConfig`` and a
device (port of the JAX package's ``models.registry``).

The families register themselves when their modules are imported;
the ``models`` package imports them all, so every name is registered as
soon as any module of the package is.
"""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register_model(name: str):
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None

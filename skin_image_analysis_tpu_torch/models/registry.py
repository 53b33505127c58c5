"""Model registry: name -> constructor taking a ``ModelConfig`` and a
device (port of the JAX package's ``models.registry``).

:data:`NOT_PORTED` lists the names the JAX package registers whose
families the port does not have yet; :func:`get_model` refuses them with
``NotImplementedError`` rather than the registry's ``KeyError``, since
the name is known, only not ported.
"""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}

#: registered by the JAX package, not ported yet (ROADMAP queue 1 item 7b)
NOT_PORTED = frozenset({
    "resnet50_v2", "resnet101_v2", "resnet152_v2", "vgg16", "vgg19",
    "mobilenet_v2",
    *(f"efficientnet_b{i}" for i in range(8)),
    *(f"efficientnet_v2_{v}" for v in ("b0", "b1", "b2", "b3", "s", "m",
                                       "l")),
})


def register_model(name: str):
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_model(name: str) -> Callable:
    if name in NOT_PORTED and name not in _REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP queue 1 item 7b)")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None

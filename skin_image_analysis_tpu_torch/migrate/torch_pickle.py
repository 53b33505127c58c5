"""Safe reader of torch ``.pth`` files: no code from the pickle runs
(port of the JAX package's ``migrate.torch_pickle``).

The reference saves trained models as whole-module pickles
(``torch.save(model, 'session_model.pth')``). ``torch.load`` of such a
file would need the reference's model classes importable and would run
whatever the pickle calls. This module parses torch's zipfile format
itself:

- every class the pickle names becomes an inert :class:`Stub` subtype
  that records its ``(module, qualname)`` and state; nothing the pickle
  names is imported or called, except an allow-list of plain data
  constructors (``collections.OrderedDict``, ``builtins.set`` ...) and
  this module's own tensor rebuilders;
- each storage loads from its zip entry into a flat tensor
  (``torch.frombuffer`` of a copy, the dtype from the pickled storage
  class's name), and a tensor is a bounds-checked strided copy of it.

The result is the pickled object graph, its ``nn.Module`` instances as
stubs whose ``_parameters`` / ``_buffers`` / ``_modules`` dicts hold
tensors on the CPU.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from collections import OrderedDict
from typing import Any, Iterator

import torch

__all__ = [
    "Stub",
    "load_pth",
    "named_modules",
    "named_tensors",
    "TorchPickleError",
]


class TorchPickleError(ValueError):
    """Anything wrong with a .pth file."""


class Stub:
    """Inert stand-in for any class a pickle names.

    ``_pickle_module`` / ``_pickle_name`` (class attributes of the
    generated subtype) record the original class; the arguments of a call
    to it (REDUCE) land in ``_args``, and instance state in ``__dict__``.
    """

    _pickle_module: str = "?"
    _pickle_name: str = "?"

    def __new__(cls, *args: Any, **kwargs: Any) -> "Stub":
        inst = object.__new__(cls)
        if args or kwargs:
            inst.__dict__["_args"] = (args, kwargs)
        return inst

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        pass

    def __setstate__(self, state: Any) -> None:
        # pickle's own fallback: a (dict, slots) pair or a dict
        if isinstance(state, tuple) and len(state) == 2:
            d, slots = state
            if d:
                self.__dict__.update(d)
            if slots:
                self.__dict__.update(slots)
        elif isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __repr__(self) -> str:
        return f"<Stub {self._pickle_module}.{self._pickle_name}>"


_STUB_CACHE: dict[tuple[str, str], type] = {}


def _stub_class(module: str, name: str) -> type:
    key = (module, name)
    cls = _STUB_CACHE.get(key)
    if cls is None:
        cls = type(f"Stub_{name}", (Stub,),
                   {"_pickle_module": module, "_pickle_name": name})
        _STUB_CACHE[key] = cls
    return cls


_STORAGE_DTYPES = {
    "FloatStorage": torch.float32,
    "DoubleStorage": torch.float64,
    "HalfStorage": torch.float16,
    "BFloat16Storage": torch.bfloat16,
    "LongStorage": torch.int64,
    "IntStorage": torch.int32,
    "ShortStorage": torch.int16,
    "CharStorage": torch.int8,
    "ByteStorage": torch.uint8,
    "BoolStorage": torch.bool,
}


def _storage_dtype(name: str) -> torch.dtype:
    try:
        return _STORAGE_DTYPES[name]
    except KeyError:
        raise TorchPickleError(
            f"unsupported torch storage type {name!r}") from None


def _rebuild_tensor_v2(
    storage: torch.Tensor,
    storage_offset: int,
    size: tuple,
    stride: tuple,
    requires_grad: bool = False,
    backward_hooks: Any = None,
    metadata: Any = None,
) -> torch.Tensor:
    """``torch._utils._rebuild_tensor_v2`` without torch's unpickler: the
    flat ``storage`` viewed at (offset, size, stride), strides in
    elements, copied out contiguous. The view comes from the (untrusted)
    pickle, so it is checked against the storage first: a corrupt or
    malicious file raises instead of reading outside it."""
    size = tuple(int(s) for s in size)
    stride = tuple(int(s) for s in stride)
    storage_offset = int(storage_offset)
    numel = storage.numel()
    if storage_offset < 0 or any(s < 0 for s in size) or any(
            s < 0 for s in stride):
        raise TorchPickleError(
            f"tensor with negative offset/size/stride "
            f"(offset={storage_offset}, size={size}, stride={stride})")
    if not size:
        if storage_offset >= numel:
            raise TorchPickleError(
                f"scalar tensor offset {storage_offset} outside storage "
                f"of {numel} elements")
        return storage[storage_offset].clone()
    if min(size) == 0:
        return torch.empty(size, dtype=storage.dtype)
    last = storage_offset + sum((s - 1) * st for s, st in zip(size, stride))
    if last >= numel:
        raise TorchPickleError(
            f"tensor view (offset={storage_offset}, size={size}, "
            f"stride={stride}) exceeds storage of {numel} elements")
    view = storage.as_strided(size, stride, storage_offset)
    return torch.empty(size, dtype=storage.dtype).copy_(view)


def _rebuild_parameter(data: torch.Tensor, requires_grad: bool = True,
                       backward_hooks: Any = None) -> torch.Tensor:
    return data


# (module, name) -> what the pickle's GLOBAL lookups get: plain data
# constructors and this module's tensor rebuilders, nothing with effects
_ALLOWED: dict[tuple[str, str], Any] = {
    ("collections", "OrderedDict"): OrderedDict,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "bytearray"): bytearray,
    ("builtins", "complex"): complex,
    ("torch", "Size"): tuple,
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
}


class _SafeUnpickler(pickle.Unpickler):
    def __init__(self, data: bytes, load_storage) -> None:
        super().__init__(io.BytesIO(data))
        self._load_storage = load_storage

    def find_class(self, module: str, name: str) -> Any:
        repl = _ALLOWED.get((module, name))
        if repl is not None:
            return repl
        return _stub_class(module, name)

    def persistent_load(self, pid: Any) -> Any:
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise TorchPickleError(f"unknown persistent id {pid!r}")
        _, storage_type, key, _location, numel = pid
        type_name = getattr(storage_type, "_pickle_name", None) or getattr(
            storage_type, "__name__", str(storage_type))
        return self._load_storage(str(key), _storage_dtype(type_name),
                                  int(numel))


def load_pth(path: str) -> Any:
    """Parse a torch zipfile ``.pth`` and return the pickled object graph
    with stub classes and CPU tensors. Anything that is not a well-formed
    torch zip archive (the pre-1.6 stream format included) raises
    :class:`TorchPickleError`."""
    try:
        zf = zipfile.ZipFile(path)
    except (zipfile.BadZipFile, OSError) as e:
        raise TorchPickleError(
            f"{path}: not a torch zipfile checkpoint (legacy pre-1.6 "
            f"torch.save streams are not supported): {e}") from e
    with zf:
        pkl_entries = [n for n in zf.namelist() if n.endswith("/data.pkl")]
        if not pkl_entries:
            raise TorchPickleError(f"{path}: no data.pkl in archive")
        prefix = pkl_entries[0][: -len("data.pkl")]

        def load_storage(key: str, dtype: torch.dtype,
                         numel: int) -> torch.Tensor:
            entry = f"{prefix}data/{key}"
            try:
                raw = zf.read(entry)
            except KeyError as e:
                raise TorchPickleError(
                    f"{path}: missing storage entry {entry}") from e
            need = numel * dtype.itemsize
            if len(raw) < need:
                raise TorchPickleError(
                    f"{path}: storage {key} truncated "
                    f"({len(raw)} < {need} bytes)")
            if numel == 0:
                return torch.empty(0, dtype=dtype)
            return torch.frombuffer(bytearray(raw[:need]), dtype=dtype)

        try:
            data = zf.read(pkl_entries[0])
            return _SafeUnpickler(data, load_storage).load()
        except TorchPickleError:
            raise
        except Exception as e:
            raise TorchPickleError(f"{path}: corrupt pickle: {e}") from e


def _module_children(stub: Any) -> "OrderedDict[str, Any]":
    mods = getattr(stub, "_modules", None)
    if isinstance(mods, dict):
        return OrderedDict((k, v) for k, v in mods.items() if v is not None)
    return OrderedDict()


def named_modules(root: Any, prefix: str = "",
                  _memo: set[int] | None = None
                  ) -> Iterator[tuple[str, Any]]:
    """``(dotted path, stub)`` of a stubbed ``nn.Module`` graph in
    definition order, as ``Module.named_modules`` walks it from the
    pickled ``_modules`` dicts. A module reached from two parents (weight
    tying) is yielded once, and a cycle, which a corrupt pickle can
    encode, ends the walk."""
    if _memo is None:
        _memo = set()
    if id(root) in _memo:
        return
    _memo.add(id(root))
    yield prefix, root
    for name, child in _module_children(root).items():
        sub = f"{prefix}.{name}" if prefix else name
        yield from named_modules(child, sub, _memo)


def named_tensors(root: Any) -> "OrderedDict[str, torch.Tensor]":
    """The ``state_dict()`` of a stubbed module: every parameter and
    buffer by its dotted path, in definition order."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, mod in named_modules(root):
        for attr in ("_parameters", "_buffers"):
            entries = getattr(mod, attr, None)
            if not isinstance(entries, dict):
                continue
            for name, value in entries.items():
                if value is None:
                    continue
                key = f"{path}.{name}" if path else name
                if not isinstance(value, torch.Tensor):
                    raise TorchPickleError(
                        f"{key}: expected a tensor, got {type(value)!r}")
                out[key] = value
    return out


def stub_kind(stub: Any) -> str:
    """The pickled class name of a stub (``Conv2d``, ...)."""
    return getattr(stub, "_pickle_name", type(stub).__name__)

"""msgpack in the form of ``flax.serialization``, without the msgpack
package.

:func:`to_bytes` packs what ``flax.serialization.to_bytes`` packs for a
tree of dicts with str keys: the same bytes, so that a file written by
either package compares equal. :func:`msgpack_restore` reads what
``flax.serialization.msgpack_restore`` reads. The encoding:

- maps in the dicts' own order, lists and tuples as maps of their
  indices ``{"0": ...}`` (flax's state dict of a sequence), str as str,
  bytes as bin, ints in their shortest form, floats as float64;
- an ndarray as ext type 1 holding the msgpack array ``(shape, dtype
  name, C-order bytes)``; a numpy scalar as ext type 3, the same for its
  0-d array;
- an array of more than :data:`MAX_CHUNK_SIZE` bytes as flax's chunked
  map ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": <flat piece>, ...}}``, each piece at most that many
  bytes.

Large arrays are written from their own memory (:func:`write`) and read
as views of the input bytes.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Iterator

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
#: flax's MAX_CHUNK_SIZE: arrays above it are stored in pieces
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"


def _uint_head(n: int, fix_base: int, fix_max: int, codes) -> bytes:
    """A length header: fix form below ``fix_max``, else 8/16/32-bit."""
    if n < fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} elements is too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _int(x: int) -> bytes:
    if 0 <= x < 128:
        return bytes([x])
    if x >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if x < limit:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        if x >= -32:
            return struct.pack(">b", x)
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if x >= -limit:
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f"int {x} does not fit msgpack")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _uint_head(len(data), 0xA0, 32, _STR) + data


def _bin_head(n: int) -> bytes:
    return _uint_head(n, 0, 0, _BIN)


def _ext_head(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        head = bytes([_FIXEXT[n]])
    elif n < 1 << 8:
        head = bytes([0xC7, n])
    elif n < 1 << 16:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack(">b", code)


def _ndarray(arr: np.ndarray, code: int) -> Iterator[bytes | memoryview]:
    """Ext ``code`` holding the msgpack array (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be packed")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")  # (ascontiguousarray makes 0-d 1-d)
    inner = (bytes([0x93]) + _uint_head(arr.ndim, 0x90, 16, _ARRAY)
             + b"".join(_int(int(d)) for d in arr.shape)
             + _str(arr.dtype.name) + _bin_head(arr.nbytes))
    yield _ext_head(code, len(inner) + arr.nbytes) + inner
    yield memoryview(arr.reshape(-1).view(np.uint8))


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {
        CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
        "chunks": {str(j): flat[i : i + size] for j, i in
                   enumerate(range(0, flat.size, size))},
    }


def _pack(obj: Any, top: bool = True) -> Iterator[bytes | memoryview]:
    if obj is None:
        yield b"\xc0"
    elif obj is True:
        yield b"\xc3"
    elif obj is False:
        yield b"\xc2"
    elif type(obj) is int:
        yield _int(obj)
    elif type(obj) is float:
        yield b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        yield _str(obj)
    elif type(obj) is bytes:
        yield _bin_head(len(obj)) + obj
    elif type(obj) is dict:
        yield _uint_head(len(obj), 0x80, 16, _MAP)
        for key, value in obj.items():
            if type(key) is not str:
                raise TypeError(f"map keys must be str, got {key!r}")
            yield _str(key)
            if (type(value) is np.ndarray
                    and value.size * value.dtype.itemsize > MAX_CHUNK_SIZE):
                value = _chunk(value)
            yield from _pack(value, top=False)
    elif type(obj) in (list, tuple):
        # flax's state dict of a sequence: a map of its indices
        yield from _pack({str(i): v for i, v in enumerate(obj)}, top=False)
    elif type(obj) is np.ndarray:
        if top and obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            yield from _pack(_chunk(obj), top=False)
        else:
            yield from _ndarray(obj, EXT_NDARRAY)
    elif isinstance(obj, np.generic):
        yield from _ndarray(np.asarray(obj), EXT_NPSCALAR)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def write(f: BinaryIO, tree: Any) -> None:
    """Write ``tree`` packed to the file ``f``, arrays from their own
    memory."""
    for piece in _pack(tree):
        f.write(piece)


def to_bytes(tree: Any) -> bytes:
    """``tree`` packed, as ``flax.serialization.to_bytes`` packs it."""
    return b"".join(_pack(tree))


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data truncated at byte {self.pos}")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {  # code: (struct format of the value)
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {  # code: (kind, struct format of the length)
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _dtype(name: str) -> np.dtype:
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported (numpy has no "
                         "bfloat16 without ml_dtypes)")
    return np.dtype(name)


def _ext(code: int, data: memoryview):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack ext type {code}")
    r = _Reader(data)
    shape, name, buf = _read(r, views=True)
    arr = np.frombuffer(buf, dtype=_dtype(name)).reshape(shape)
    return arr[()] if code == EXT_NPSCALAR else arr


def _read(r: _Reader, views: bool = False):
    """The next object; bin data as bytes, or with ``views`` as a view of
    the input."""
    code = r.take(1)[0]
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code == 0xC0:
        return None
    elif code in (0xC2, 0xC3):
        return code == 0xC3
    elif code in _FIXED:
        return r.unpack(_FIXED[code])
    elif code in _FIXEXT_LEN:
        kind, n = "ext", _FIXEXT_LEN[code]
    elif code in _LEN:
        kind, fmt = _LEN[code]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"unknown msgpack code 0x{code:02x}")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return r.take(n) if views else bytes(r.take(n))
    if kind == "array":
        return [_read(r, views) for _ in range(n)]
    if kind == "map":
        out = {}
        for _ in range(n):
            key = _read(r)
            out[key] = _read(r)
        return out
    ext_code = r.unpack(">b")
    return _ext(ext_code, r.take(n))


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data) -> Any:
    """The tree that ``data`` (bytes or a buffer) packs; arrays are
    read-only views of it, chunked arrays joined."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after "
                         "the msgpack object")
    return _unchunk(tree)

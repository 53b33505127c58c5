"""ctypes binding of the port's threaded libjpeg decoder,
``csrc/decoder.cc`` (port of the JAX package's ``data.native_loader``).

The library is built with ``g++`` from the checkout's source the first
time it is needed (``ops.kernels.build.load_host``); a build that fails
is remembered, and :func:`available` is then False, so callers fall back
to the cv2/PIL path. The batch call releases the GIL for its whole
duration: the decode threads run in parallel.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from skin_image_analysis_tpu_torch.ops.kernels import build

_lock = threading.Lock()
_decoder: build.HostLibrary | None = None
_build_error: str | None = None


def _load() -> build.HostLibrary:
    global _decoder, _build_error
    with _lock:
        if _decoder is not None:
            return _decoder
        if _build_error is not None:
            raise RuntimeError(
                f"native decoder build previously failed: {_build_error}")
        try:
            decoder = build.load_host("decoder")
        except RuntimeError as e:
            _build_error = str(e)
            raise RuntimeError(f"native decoder build failed: {e}") from e
        fn = decoder.lib.sia_decode_batch
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        _decoder = decoder
        return decoder


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def library() -> tuple[str, str]:
    """(libjpeg route, library path) of the decoder, building it if
    needed: the route is ``"system"`` or ``"pillow"`` (PIL's bundled
    libjpeg-turbo)."""
    decoder = _load()
    return decoder.route, str(decoder.path)


def decode_batch_into(
    paths: list[str], out: np.ndarray, n_threads: int | None = None,
    on_error: str = "raise",
) -> int | list[int]:
    """Decode ``paths`` into the preallocated uint8 arena, HWC
    ``out[N, S, S, 3]`` or planar ``out[N, 3, S, S]`` (the layout is read
    from the shape).

    ``on_error="raise"`` raises IOError when any image fails and returns
    the decoded count; ``on_error="report"`` returns the list of failed
    indices instead (possibly empty), so that the caller retries just
    those slots. A failed slot is zero-filled either way."""
    lib = _load().lib
    n = len(paths)
    if (out.shape[0] != n or out.dtype != np.uint8
            or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"bad arena: shape={out.shape} dtype={out.dtype}")
    if out.ndim == 4 and out.shape[3] == 3 and out.shape[1] == out.shape[2]:
        planar, size = 0, out.shape[1]
    elif out.ndim == 4 and out.shape[1] == 3 and out.shape[2] == out.shape[3]:
        planar, size = 1, out.shape[2]
    else:
        raise ValueError(
            f"arena must be [N,S,S,3] or [N,3,S,S], got {out.shape}")
    if n_threads is None:
        n_threads = min(16, (os.cpu_count() or 1) * 2)

    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failed_idx = (ctypes.c_int * n)()
    n_failed = ctypes.c_int(0)
    ok = lib.sia_decode_batch(
        c_paths,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        size,
        n_threads,
        failed_idx,
        ctypes.byref(n_failed),
        planar,
    )
    if on_error == "report":
        return [failed_idx[i] for i in range(n_failed.value)]
    if n_failed.value:
        bad = [paths[failed_idx[i]] for i in range(min(n_failed.value, 5))]
        raise IOError(
            f"native decoder failed on {n_failed.value}/{n} images, "
            f"e.g. {bad}"
        )
    return ok

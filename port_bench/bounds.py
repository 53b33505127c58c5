"""The least time of a preprocess call, from its shapes and dtypes: the
larger of the bytes it must move over the memory peak and its operations
over the float32 peak.

The arithmetic is a frozen copy of the repository's ``chip_smoke.py``
(its kernel phase): the crop read once (uint8), the output written once,
the gathered rows' int32 indices, the draws (int32 offsets and flips),
the per-image float32 scale and bias and, with the colour-jitter tail,
the contrast and saturation factors and the per-image post scale and
bias; 2 operations a pixel, 14 with the tail.
"""

from __future__ import annotations


def preprocess_bytes_ops(b: int, c: int, t: int, out_bytes: int,
                         rows: bool, tail: bool) -> tuple[int, int]:
    n_px = b * c * t * t
    moved = (n_px + n_px * out_bytes + (b * 4 if rows else 0)
             + b * 2 * 4 + b * 4 + 2 * b * c * 4
             + (2 * b * 4 + 2 * b * c * 4 if tail else 0))
    return moved, n_px * (14 if tail else 2)


def preprocess_bound_s(b: int, c: int, t: int, out_bytes: int, rows: bool,
                       tail: bool, peaks: dict) -> float:
    moved, ops = preprocess_bytes_ops(b, c, t, out_bytes, rows, tail)
    return max(moved / peaks["memory_bytes_per_s"], ops / peaks["f32_flops"])

"""Decode once into a planar uint8 arena (port of the JAX package's
``data.loader``: ``decode_image``, ``rescale_image`` and
``HostImageStore`` in its planar layout).

Every image is decoded and brought to the canonical square once, into one
contiguous ``[N, 3, S, S]`` uint8 array; :meth:`HostImageStore.to_device`
then copies it to the card from pinned host memory, and the train and
eval steps gather their batches there.

Decoding follows the JAX package path for path: a DICOM goes through the
built-in parser (``data.dicom``), any other file through cv2, else PIL,
and a frame is resized with cv2, else PIL. A native-pixel DICOM already
at the canonical size needs neither, which is the form a host without
them (the card's machine) can ingest; any other file or size there raises
an ImportError that names the missing packages. No other resize stands
in for theirs: a different bilinear would give a different arena. Not
ported: the libjpeg ``native_loader`` and the streaming and host-batch
feeds.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from skin_image_analysis_tpu_torch.data.dataset import LesionTable

_NO_DECODER = ("needs cv2 (opencv-python) or PIL (pillow), and neither is "
               "installed")


def _decode_resize_cv2(path: str, size: int) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR uint8
    if img is None:
        raise IOError(f"failed to decode {path}")
    interp = cv2.INTER_AREA if img.shape[0] > size else cv2.INTER_LINEAR
    img = cv2.resize(img, (size, size), interpolation=interp)
    return img[:, :, ::-1]  # BGR -> RGB


def _decode_resize_pil(path: str, size: int) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"decoding {path} {_NO_DECODER}") from None

    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def decode_image(path: str, size: int) -> np.ndarray:
    """Decode one image to uint8 ``[size, size, 3]`` RGB, resized exactly
    (the JAX package's ``mode="square"``, the pipeline's)."""
    if path.lower().endswith(".dcm"):
        from skin_image_analysis_tpu_torch.data.dicom import read_dicom_image

        return rescale_image(read_dicom_image(path), (size, size))
    try:
        return _decode_resize_cv2(path, size)
    except ImportError:
        return _decode_resize_pil(path, size)


def rescale_image(
    img: np.ndarray, output_size: int | tuple[int, int]
) -> np.ndarray:
    """The reference's Rescale: an int makes the shortest side
    ``output_size``, keeping the aspect; an (h, w) tuple resizes exactly.
    A frame already at that size comes back unchanged."""
    h, w = img.shape[:2]
    if isinstance(output_size, int):
        if h < w:
            new_h, new_w = output_size, max(round(output_size * w / h), 1)
        else:
            new_h, new_w = max(round(output_size * h / w), 1), output_size
    else:
        new_h, new_w = output_size
    if (new_h, new_w) == (h, w):
        return img
    try:
        import cv2
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            raise ImportError(f"resizing a {h}x{w} frame to {new_h}x{new_w} "
                              f"{_NO_DECODER}") from None
        im = Image.fromarray(img).resize((new_w, new_h), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)
    interp = cv2.INTER_AREA if h > new_h else cv2.INTER_LINEAR
    return cv2.resize(img, (new_w, new_h), interpolation=interp)


class HostImageStore:
    """The decoded planar uint8 arena ``[N, 3, S, S]`` of one split.

    A file that fails to decode (missing, corrupt) is zero-filled and its
    row listed in ``bad_rows``; the batches mark such rows invalid. A
    missing decoder package is no bad file: its ImportError propagates."""

    def __init__(
        self,
        table: LesionTable,
        canonical_size: int = 256,
        workers: int = 8,
    ):
        self.table = table
        self.size = canonical_size
        paths = table.file_paths()
        self.images = np.empty((len(paths), 3, canonical_size,
                                canonical_size), np.uint8)

        def one(i: int) -> bool:
            try:
                img = decode_image(paths[i], canonical_size)
            except ImportError:
                raise
            except Exception:
                self.images[i] = 0
                return False
            self.images[i] = np.transpose(img, (2, 0, 1))
            return True

        rows = range(len(paths))
        if workers > 1 and len(paths) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                ok = list(pool.map(one, rows))
        else:
            ok = [one(i) for i in rows]
        self.bad_rows = [i for i in rows if not ok[i]]
        if self.bad_rows:
            warnings.warn(
                f"{len(self.bad_rows)} image(s) failed to decode and were "
                f"zero-filled (first: {paths[self.bad_rows[0]]})",
                stacklevel=2)

    def __len__(self) -> int:
        return len(self.images)

    @property
    def row_ok(self) -> np.ndarray:
        """False on the rows whose decode failed."""
        ok = np.ones(len(self.images), bool)
        ok[self.bad_rows] = False
        return ok

    def to_device(self, device) -> torch.Tensor:
        """The arena as a tensor on ``device``: on a card, copied once from
        pinned host memory."""
        arena = torch.from_numpy(self.images)
        device = torch.device(device)
        if device.type == "cuda":
            return arena.pin_memory().to(device, non_blocking=True)
        return arena.to(device)

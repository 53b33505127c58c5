"""Decode once into a planar uint8 arena, and feed it to the card (port
of the JAX package's ``data.loader``: ``decode_image``,
``decode_image_bytes``, ``rescale_image``, ``HostImageStore`` in its
planar layout, and ``BatchIterator``).

Every image is decoded and brought to the canonical square once, into one
contiguous ``[N, 3, S, S]`` uint8 array. Where that arena fits on the
card, :meth:`HostImageStore.to_device` copies it there from pinned host
memory once, and the train and eval steps gather their batches on the
card. Where it does not, :class:`BatchIterator` gathers each batch on the
host into a pinned buffer and uploads it on a copy stream of its own, a
few batches ahead of the step.

Decoding follows the JAX package path for path. :class:`HostImageStore`
decodes a cohort through the threaded libjpeg decoder
(``data.native_loader``) first, and retries only the slots it reports
(a DICOM, a PNG, a corrupt file) through :func:`decode_image`; where the
decoder cannot be built, every row takes that path. There a DICOM goes
through the built-in parser (``data.dicom``), any other file through
cv2, else PIL, and a frame is resized with cv2, else PIL. A native-pixel
DICOM already at the canonical size needs neither, which is the form a
host without them can ingest; any other file or size there raises an
ImportError that names the missing packages. No other resize stands in
for theirs: a different bilinear would give a different arena. Cohorts
too large to decode whole stream in chunks (``data.streaming``).
"""

from __future__ import annotations

import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from skin_image_analysis_tpu_torch.data import native_loader
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


def _read_rgb(path: str) -> np.ndarray:
    """One file's uint8 RGB frame at its own size: cv2, else PIL."""
    try:
        import cv2
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            raise ImportError(f"decoding {path} {_NO_DECODER}") from None
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"failed to decode {path}")
    return img[:, :, ::-1]


def _centre_square(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    y0, x0 = (h - size) // 2, (w - size) // 2
    return np.ascontiguousarray(img[y0 : y0 + size, x0 : x0 + size])


def decode_image(path: str, size: int, mode: str = "square") -> np.ndarray:
    """Decode one image to uint8 ``[size, size, 3]`` RGB.

    ``mode="square"`` resizes exactly (the pipeline's, the reference's
    ``Rescale((224, 224))``); ``mode="shortest"`` brings the shortest
    side to ``size``, keeping the aspect (the reference's
    ``Rescale(int)``), then takes the centre square, for JPEGs, PNGs and
    DICOM frames alike."""
    if path.lower().endswith(".dcm"):
        from skin_image_analysis_tpu_torch.data.dicom import read_dicom_image

        img = read_dicom_image(path)
        if mode == "shortest":
            return _centre_square(rescale_image(img, size), size)
        return rescale_image(img, (size, size))
    if mode == "shortest":
        return _centre_square(rescale_image(_read_rgb(path), size), size)
    try:
        return _decode_resize_cv2(path, size)
    except ImportError:
        return _decode_resize_pil(path, size)


def decode_image_bytes(data: bytes, size: int) -> np.ndarray:
    """Decode an in-memory encoded image (JPEG or PNG bytes) to uint8
    ``[size, size, 3]`` RGB, at :func:`decode_image`'s exact-resize
    geometry: the serving twin of it. cv2, else PIL; an ImportError names
    both when neither is installed."""
    try:
        import cv2
    except ImportError:
        try:
            from PIL import Image
        except ImportError:
            raise ImportError(f"decoding image bytes {_NO_DECODER}") from None
        import io

        with Image.open(io.BytesIO(data)) as im:
            im = im.convert("RGB").resize((size, size), Image.BILINEAR)
            return np.asarray(im, dtype=np.uint8)
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError("failed to decode image bytes")
    interp = cv2.INTER_AREA if img.shape[0] > size else cv2.INTER_LINEAR
    img = cv2.resize(img, (size, size), interpolation=interp)
    return np.ascontiguousarray(img[:, :, ::-1])


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

    With ``use_native`` (the default) the libjpeg decoder fills the arena
    and :func:`decode_image` retries the slots it reports, on ``workers``
    threads; an all-DICOM cohort skips the decoder. A file that fails
    both (missing, corrupt) is zero-filled and its row listed in
    ``bad_rows``; the batches mark such rows invalid. A missing decoder
    package is no bad file: its ImportError propagates.
    ``resize_mode`` is :func:`decode_image`'s ``mode``; "shortest" skips
    the libjpeg decoder, which makes exact squares only. The JAX
    package's ``layout="hwc"`` holds the same pixels in another order:
    the port's arena is planar always."""

    def __init__(
        self,
        table: LesionTable,
        canonical_size: int = 256,
        workers: int = 8,
        use_native: bool = True,
        resize_mode: str = "square",
    ):
        if resize_mode not in ("square", "shortest"):
            raise ValueError(
                f"resize_mode must be square|shortest, got {resize_mode!r}")
        self.table = table
        self.size = canonical_size
        self.resize_mode = resize_mode
        paths = table.file_paths()
        self.images = np.empty((len(paths), 3, canonical_size,
                                canonical_size), np.uint8)
        if resize_mode != "square":
            use_native = False
        if paths and all(p.lower().endswith(".dcm") for p in paths):
            # the libjpeg decoder would report every slot of an all-DICOM
            # cohort; mixed cohorts keep it and retry the DICOM slots
            use_native = False
        todo = range(len(paths))
        mode = {} if resize_mode == "square" else {"mode": resize_mode}
        if use_native and native_loader.available():
            todo = native_loader.decode_batch_into(paths, self.images,
                                                   on_error="report")

        def one(i: int) -> bool:
            try:
                img = decode_image(paths[i], canonical_size, **mode)
            except ImportError:
                raise
            except Exception:
                self.images[i] = 0
                return False
            self.images[i] = np.transpose(img, (2, 0, 1))
            return True

        if workers > 1 and len(todo) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                ok = list(pool.map(one, todo))
        else:
            ok = [one(i) for i in todo]
        self.bad_rows = sorted(i for i, good in zip(todo, ok) if not good)
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


def _pad_to(n: int, arr: np.ndarray, fill=0) -> np.ndarray:
    if len(arr) == n:
        return arr
    pad = np.full((n - len(arr), *arr.shape[1:]), fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


class BatchIterator:
    """Epoch iterator over a :class:`HostImageStore`: a seeded shuffle,
    batches gathered on the host, uploaded to ``device``.

    Yields dicts ``{"pixels" u8 [B, 3, S, S], "label" i32 [B], "row_id"
    i32 [B], "valid" bool [B]}``, all on ``device``. The order is the JAX
    package's: ``np.random.default_rng(seed)``, one shuffle an epoch, or
    ``order_fn(rng)`` in place of the shuffle (the oversampler's draw
    with replacement); :meth:`epoch_order` gives it alone, for a caller
    that gathers from an arena on the card. A
    short last batch is padded with rows of ``valid=False`` and
    ``row_id`` -1 (gathering row 0), or dropped with ``drop_remainder``;
    rows whose decode failed are invalid.

    On a card each batch is gathered into a pinned buffer (a ring of
    ``prefetch + 1``) and uploaded with ``non_blocking=True`` on a copy
    stream; the consumer's stream waits for that upload only. With
    ``prefetch > 0`` one thread makes that many batches ahead, and an
    error there (a gather, an upload) is raised in the consumer."""

    def __init__(self, store: HostImageStore, batch_size: int, *, device,
                 shuffle: bool = True, drop_remainder: bool = False,
                 seed: int = 0, prefetch: int = 2, order_fn=None):
        self.store = store
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.order_fn = order_fn
        self._row_ok = store.row_ok
        self._images = torch.from_numpy(store.images)

    def __len__(self) -> int:
        n = len(self.store)
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def epoch_order(self) -> np.ndarray:
        """The next epoch's arena rows (one draw from the iterator's
        generator)."""
        if self.order_fn is not None:
            return np.asarray(self.order_fn(self.rng))
        order = np.arange(len(self.store))
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def super_batches(self, k: int, with_row_ids: bool = False
                      ) -> Iterator[tuple[np.ndarray, ...]]:
        """The next epoch as ``[k, B]`` host arrays for
        ``train.step.multi_train_step``, whose batches the step gathers
        from an arena on the device: ``(idx, label, valid)``, or ``(idx,
        label, row_id, valid)`` with ``with_row_ids`` (row id -1 on padded
        rows) for ``multi_eval_step``. A partial last batch is padded with
        invalid rows (or dropped with ``drop_remainder``), the last call
        with all-invalid (inert) steps."""
        order = self.epoch_order()
        table = self.store.table
        bs = self.batch_size
        n_batches = (len(order) // bs if self.drop_remainder
                     else -(-len(order) // bs))
        idx_all = (order[: n_batches * bs] if self.drop_remainder
                   else _pad_to(n_batches * bs, order))
        valid_all = np.zeros(n_batches * bs, bool)
        kept = min(len(order), n_batches * bs)
        valid_all[:kept] = self._row_ok[order[:kept]]
        idx_all = idx_all.reshape(n_batches, bs).astype(np.int32)
        valid_all = valid_all.reshape(n_batches, bs)
        labels_all = table.labels[idx_all].astype(np.int32)
        rows_all = (np.where(valid_all, table.row_ids[idx_all], -1)
                    .astype(np.int32) if with_row_ids else None)
        for start in range(0, n_batches, k):
            ib = idx_all[start : start + k]
            lb = labels_all[start : start + k]
            vd = valid_all[start : start + k]
            rid = None if rows_all is None else rows_all[start : start + k]
            if len(ib) < k:
                pad = k - len(ib)
                ib = np.concatenate([ib, np.zeros((pad, bs), np.int32)])
                lb = np.concatenate([lb, np.zeros((pad, bs), np.int32)])
                vd = np.concatenate([vd, np.zeros((pad, bs), bool)])
                if rid is not None:
                    rid = np.concatenate([rid, -np.ones((pad, bs),
                                                        np.int32)])
            yield (ib, lb, rid, vd) if with_row_ids else (ib, lb, vd)

    def _host_batches(self) -> Iterator[tuple[np.ndarray, ...]]:
        """(arena rows, labels, row ids, valid) of each batch, padded."""
        order = self.epoch_order()
        table = self.store.table
        bs = self.batch_size
        n = len(order)
        stop = (n // bs) * bs if self.drop_remainder else n
        for start in range(0, stop, bs):
            idx = order[start : start + bs]
            labels = table.labels[idx]
            row_ids = table.row_ids[idx]
            valid = self._row_ok[idx]
            if len(idx) < bs:
                idx = _pad_to(bs, idx)
                labels = _pad_to(bs, labels)
                row_ids = _pad_to(bs, row_ids, fill=-1)
                valid = _pad_to(bs, valid, fill=False)
            yield (idx, labels.astype(np.int32), row_ids.astype(np.int32),
                   valid.astype(bool))

    def _batches(self, stop: threading.Event | None = None):
        """(batch, upload event or None) for each batch of an epoch."""
        on_card = self.device.type == "cuda"
        ring: list[tuple[torch.Tensor, torch.cuda.Event | None]] = []
        stream = torch.cuda.Stream(self.device) if on_card else None
        shape = (self.batch_size, *self._images.shape[1:])
        for i, (idx, labels, row_ids, valid) in enumerate(
                self._host_batches()):
            if stop is not None and stop.is_set():
                return
            rows = torch.from_numpy(idx.astype(np.int64))
            small = {"label": torch.from_numpy(labels),
                     "row_id": torch.from_numpy(row_ids),
                     "valid": torch.from_numpy(valid)}
            if not on_card:
                pixels = torch.index_select(self._images, 0, rows)
                yield ({"pixels": pixels.to(self.device),
                        **{k: v.to(self.device) for k, v in small.items()}},
                       None)
                continue
            slot = i % (self.prefetch + 1)
            if len(ring) <= slot:
                ring.append((torch.empty(shape, dtype=torch.uint8,
                                         pin_memory=True), None))
            buf, done = ring[slot]
            if done is not None:
                done.synchronize()  # the buffer's last upload has landed
            torch.index_select(self._images, 0, rows, out=buf)
            with torch.cuda.stream(stream):
                batch = {"pixels": buf.to(self.device, non_blocking=True),
                         **{k: v.pin_memory().to(self.device,
                                                 non_blocking=True)
                            for k, v in small.items()}}
                uploaded = torch.cuda.Event()
                uploaded.record(stream)
            ring[slot] = (buf, uploaded)
            yield batch, uploaded

    def _ready(self, item):
        batch, uploaded = item
        if uploaded is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(uploaded)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def __iter__(self) -> Iterator[dict]:
        if self.prefetch <= 0:
            for item in self._batches():
                yield self._ready(item)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                for item in self._batches(stop):
                    if not put(item):
                        return
            except BaseException as e:  # raised in the consumer
                put(e)
                return
            put(end)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._ready(item)
        finally:
            stop.set()
            thread.join()

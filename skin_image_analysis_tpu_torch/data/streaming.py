"""Streaming chunked ingest for cohorts beyond host or device memory (port
of the JAX package's ``data.streaming``).

``HostImageStore`` decodes a whole cohort into one arena, which is right
for the tone dataset and wrong for an archive of 33k+ images.
:class:`ChunkedBatchIterator` streams instead, with the JAX iterator's
semantics:

- one ``np.random.default_rng(seed)`` is kept across epochs; each epoch
  reshuffles the global order with it and splits it into chunks of
  ``chunk_size`` rows (``chunk_size % batch_size == 0``);
- a background thread decodes chunk i+1 while chunk i trains. It does
  host work only (decode, cache reads and writes); uploads happen on the
  consumer's thread;
- each chunk crosses to the device once: one ``non_blocking`` copy from
  pinned host memory on a copy stream the consumer owns, then one
  permute on the device into a planar ``[chunk_size, 3, S, S]`` uint8
  arena, the tail chunk padded with zero rows there so shapes stay
  fixed;
- with a ``cache_path``, the canonical uint8 frames spill to a disk
  memmap (``[N, S, S, 3]``, the JAX package's HWC layout and file, so a
  cache written by one package is read by the other) while the first
  epoch decodes; later epochs read the memmap and decode nothing. With
  ``cache_reader`` the iterator never writes that file: it decodes until
  the cache's writer (another process) has flagged it complete, then
  reads it from the next epoch on;
- a file that fails to decode is zero-filled, its rows are served with
  ``valid=False``, and a warning names it; a ready cache keeps that set
  in its ``.bad`` sidecar, written before the ``.ready`` flag (a
  ``.ready`` without ``.bad`` is distrusted and decoded again).

Decoding goes through the libjpeg decoder (``data.native_loader``)
first, as the JAX package's does, and the slots it reports (a DICOM, a
corrupt file) through ``data.loader.decode_image`` (cv2 or PIL, or the
built-in DICOM parser), as does every slot where the decoder cannot be
built. A missing decoder package raises, as the loader's does: it is no
bad file.

Batches are ``{"arena", "rows", "label", "row_id", "valid"}`` on the
device: the chunk's planar arena and this batch's rows of it, the form
the train step hands to the fused preprocess kernel, which gathers the
rows itself (the main path's gather form: no per-batch copy of the
pixels; ``train.evaluate.batch_pixels`` gathers them for eval). The
cohort's last partial batch is padded (labels 0, ``row_id`` -1, valid
False, gathering chunk row 0); with ``drop_remainder`` each chunk's
remainder is dropped instead. Every process of a data-parallel run
streams the whole chunks (each rank trains its rows of every batch).
"""

from __future__ import annotations

import os
import queue
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from skin_image_analysis_tpu_torch.data import native_loader
from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.loader import decode_image

_END = object()


def cache_file(folder: str, split: str, canonical_size: int) -> str:
    """The JAX package's stream-cache file of a split in an experiment
    folder."""
    return os.path.join(folder, f"stream_cache_{split}_{canonical_size}.npy")


class ChunkedBatchIterator:
    def __init__(
        self,
        table: LesionTable,
        canonical_size: int = 256,
        batch_size: int = 32,
        chunk_size: int = 2048,
        shuffle: bool = True,
        drop_remainder: bool = True,
        seed: int = 0,
        device="cuda",
        decode_ahead: int = 1,
        cache_path: str | None = None,
        workers: int = 8,
        cache_reader: bool = False,
    ):
        if chunk_size % batch_size:
            raise ValueError(
                f"chunk_size {chunk_size} must be a multiple of "
                f"batch_size {batch_size}"
            )
        self.table = table
        self.size = canonical_size
        self.batch_size = batch_size
        self.chunk_size = chunk_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.decode_ahead = max(1, decode_ahead)
        self.workers = workers
        self._paths = table.file_paths()
        # frames decoded from files, and read from the cache, so far, and
        # the seconds the decode took (the producer's own clock)
        self.frames_decoded = 0
        self.frames_cached = 0
        self.decode_seconds = 0.0
        # global rows whose decode failed (zero-filled frames), served
        # with valid=False; a complete cache persists the set beside its
        # ready flag, so a resumed process keeps them invalid
        self._bad: set[int] = set()
        self._host_bufs: list[torch.Tensor] = []
        self._copy_stream = None
        # decode-once disk cache: canonical uint8 memmap [N, S, S, 3]
        self._cache = None
        self._cache_ready = None
        self._reader_path = cache_path if cache_reader else None
        if cache_path and not cache_reader:
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            n = len(self._paths)
            shape = (n, self.size, self.size, 3)
            if os.path.exists(cache_path):
                self._cache = np.lib.format.open_memmap(cache_path,
                                                        mode="r+")
            else:
                self._cache = np.lib.format.open_memmap(
                    cache_path, mode="w+", dtype=np.uint8, shape=shape)
            if self._cache.shape != shape:
                raise ValueError(
                    f"cache {cache_path} shape {self._cache.shape} != {shape}"
                )
            self._cache_flag = cache_path + ".ready"
            self._bad_file = cache_path + ".bad"
            self._cache_ready = np.zeros(n, bool)
            if os.path.exists(self._cache_flag) \
                    and os.path.exists(self._bad_file):
                self._cache_ready[:] = np.fromfile(self._cache_flag,
                                                   bool)[:n]
                self._bad.update(int(i) for i in
                                 np.fromfile(self._bad_file, np.int64))
            # else: a ready flag without the bad-row sidecar cannot prove
            # which zero frames are corrupt: decode again (the cache
            # rewrites both files)

    def _attach_ready_cache(self) -> None:
        """A cache reader's cache, read-only, once its writer has flagged
        it complete (``.bad`` and ``.ready`` both there); until then the
        reader decodes."""
        path = self._reader_path
        if self._cache is not None or not (
                os.path.exists(path + ".ready")
                and os.path.exists(path + ".bad")):
            return
        cache = np.lib.format.open_memmap(path, mode="r")
        shape = (len(self._paths), self.size, self.size, 3)
        if cache.shape != shape:
            raise ValueError(f"cache {path} shape {cache.shape} != {shape}")
        self._cache_ready = np.fromfile(path + ".ready", bool)[:shape[0]]
        self._bad.update(int(i) for i in np.fromfile(path + ".bad",
                                                     np.int64))
        self._cache = cache

    # -- host side (the decode thread) -----------------------------------

    def _decode_chunk(self, idx: np.ndarray, out: np.ndarray) -> None:
        """Fill ``out[:len(idx)]`` with the frames of rows ``idx`` (HWC
        uint8), from the cache when it holds them all; zero the rest."""
        n = len(idx)
        out[n:] = 0
        if self._cache is not None and self._cache_ready[idx].all():
            out[:n] = self._cache[idx]
            self.frames_cached += n
            return
        t0 = time.perf_counter()
        paths = [self._paths[i] for i in idx]
        todo = range(n)
        if native_loader.available():
            # report mode: a corrupt file costs a retry of its slot only
            todo = native_loader.decode_batch_into(paths, out[:n],
                                                   on_error="report")

        def one(j: int) -> bool:
            try:
                out[j] = decode_image(paths[j], self.size)
            except ImportError:
                raise
            except Exception:
                out[j] = 0  # corrupt file: zero-fill, keep streaming
                return False
            return True

        if self.workers > 1 and len(todo) > 1:
            with ThreadPoolExecutor(max_workers=self.workers) as pool:
                ok = list(pool.map(one, todo))
        else:
            ok = [one(j) for j in todo]
        bad_local = sorted(j for j, good in zip(todo, ok) if not good)
        if bad_local:
            self._bad.update(int(idx[j]) for j in bad_local)
            warnings.warn(
                f"{len(bad_local)} image(s) failed to decode in a chunk "
                f"and were zero-filled (first: {paths[bad_local[0]]})",
                stacklevel=2,
            )
        self.frames_decoded += n
        self.decode_seconds += time.perf_counter() - t0
        if self._cache is not None and not self._reader_path:
            self._cache[idx] = out[:n]
            self._cache_ready[idx] = True
            if self._cache_ready.all():
                self._cache.flush()
                # bad-row set BEFORE the ready flag: a crash in between
                # leaves an unflagged cache (re-validated on reuse),
                # never a ready cache without its corrupt rows
                np.asarray(sorted(self._bad), np.int64).tofile(
                    self._bad_file)
                self._cache_ready.tofile(self._cache_flag)

    def _chunk_indices(self):
        order = np.arange(len(self.table))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.chunk_size):
            yield order[start : start + self.chunk_size]

    # -- device side (the consumer) --------------------------------------

    def _buffers(self) -> list[torch.Tensor]:
        """``decode_ahead + 2`` host chunk buffers (pinned on a card): one
        being decoded, ``decode_ahead`` waiting, one being uploaded."""
        if not self._host_bufs:
            shape = (self.chunk_size, self.size, self.size, 3)
            pin = self.device.type == "cuda"
            self._host_bufs = [
                torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
                for _ in range(self.decode_ahead + 2)]
        return self._host_bufs

    def _upload(self, host: torch.Tensor, n: int):
        """(planar ``[chunk_size, 3, S, S]`` arena on the device, the copy's
        event or None). Rows past ``n`` are zero."""
        if self.device.type != "cuda":
            return host.permute(0, 3, 1, 2).contiguous(), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            staged = host[:n].to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(copied)
        staged.record_stream(compute)
        arena = torch.empty((self.chunk_size, 3, self.size, self.size),
                            dtype=torch.uint8, device=self.device)
        arena[:n].copy_(staged.permute(0, 3, 1, 2))
        if n < self.chunk_size:
            arena[n:].zero_()
        return arena, copied

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _chunk_batches(self, idx: np.ndarray, arena: torch.Tensor):
        """The batches of one chunk; their small arrays cross to the
        device in one copy each per chunk."""
        bs, n = self.batch_size, len(idx)
        stop = (n // bs) * bs if self.drop_remainder else n
        n_batches = -(-stop // bs)
        if n_batches == 0:
            return
        padded = n_batches * bs
        take = idx[:stop]
        local = np.zeros(padded, np.int32)
        local[:stop] = np.arange(stop, dtype=np.int32)
        labels = np.zeros(padded, np.int32)
        labels[:stop] = self.table.labels[take]
        row_ids = np.full(padded, -1, np.int32)
        row_ids[:stop] = self.table.row_ids[take]
        valid = np.zeros(padded, bool)
        # the decode thread adds a chunk's bad rows before handing it over;
        # sorted() copies the set in one step under the GIL
        bad = np.asarray(sorted(self._bad), np.int64)
        valid[:stop] = ~np.isin(take, bad)
        on_dev = [self._to_device(a.reshape(n_batches, bs))
                  for a in (local, labels, row_ids, valid)]
        for i in range(n_batches):
            rows, lab, rid, vd = (t[i] for t in on_dev)
            yield {"arena": arena, "rows": rows, "label": lab,
                   "row_id": rid, "valid": vd}

    def __iter__(self):
        if self._reader_path:
            self._attach_ready_cache()
        bufs = self._buffers()
        free: queue.Queue = queue.Queue()
        for buf in bufs:
            free.put(buf)
        ready: queue.Queue = queue.Queue(maxsize=self.decode_ahead)
        stop = threading.Event()

        def put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def take_free():
            while not stop.is_set():
                try:
                    return free.get(timeout=0.1)
                except queue.Empty:
                    pass
            return None

        def producer():
            try:
                for idx in self._chunk_indices():
                    buf = take_free()
                    if buf is None:
                        return
                    self._decode_chunk(idx, buf.numpy())
                    if not put(ready, (idx, buf)):
                        return
            except BaseException as e:  # raised in the consumer
                put(ready, e)
                return
            put(ready, _END)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        pending = None
        try:
            while True:
                item = ready.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                idx, buf = item
                arena, copied = self._upload(buf, len(idx))
                if pending is not None:
                    # the previous chunk's copy went ahead of a chunk of
                    # steps: its buffer returns to the decoder once landed
                    pending[1].synchronize()
                    free.put(pending[0])
                    pending = None
                if copied is None:
                    free.put(buf)
                else:
                    pending = (buf, copied)
                yield from self._chunk_batches(idx, arena)
        finally:
            stop.set()
            thread.join()
            if pending is not None:
                pending[1].synchronize()

    def __len__(self) -> int:
        n = len(self.table)
        if self.drop_remainder:
            # remainder dropped per chunk
            full_chunks, rem = divmod(n, self.chunk_size)
            return full_chunks * (self.chunk_size // self.batch_size) + (
                rem // self.batch_size
            )
        return -(-n // self.batch_size)

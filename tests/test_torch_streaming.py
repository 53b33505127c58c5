"""The port's streaming ingest (``data.streaming``) against the JAX
package's, on the CPU: the counterparts of ``tests/test_streaming.py``,
each holding the port's batches against the JAX iterator's on the same
table and seed (order, labels, row ids, validity, and the pixels of the
port's planar chunk rows transposed to the JAX package's HWC), plus the
stream cache shared across the packages. Both iterators decode through
their libjpeg decoders, which give the same bytes."""

import os
import shutil

import numpy as np
import pytest

from skin_image_analysis_tpu.data import LesionTable as JLesionTable
from skin_image_analysis_tpu.data import read_isic_metadata as jread
from skin_image_analysis_tpu.data import streaming as jstreaming
from skin_image_analysis_tpu_torch.data import LesionTable, read_isic_metadata
from skin_image_analysis_tpu_torch.data import native_loader as tnative
from skin_image_analysis_tpu_torch.data import streaming as tstreaming
from skin_image_analysis_tpu_torch.data.loader import HostImageStore
from skin_image_analysis_tpu_torch.train.evaluate import batch_pixels
from tests.test_torch_native_loader import same_decoders


@pytest.fixture(autouse=True)
def _same_decoders(monkeypatch):
    same_decoders(monkeypatch)


def _tables(root):
    return (LesionTable(read_isic_metadata(root, seed=0), root),
            JLesionTable(jread(root, seed=0), root))


@pytest.fixture(scope="module")
def tables(synth_root):
    return _tables(synth_root)  # 40 rows


def _port(table, **kw):
    return tstreaming.ChunkedBatchIterator(table, device="cpu", workers=2,
                                           **kw)


def _jax(table, **kw):
    return jstreaming.ChunkedBatchIterator(table, device_chunks=False, **kw)


def _epoch(it, port: bool) -> list[tuple[np.ndarray, ...]]:
    """(row_id, label, valid, HWC pixels) of each batch of one epoch."""
    out = []
    for b in it:
        px = (batch_pixels(b).permute(0, 2, 3, 1).numpy() if port
              else np.asarray(b["pixels"]))
        out.append((np.asarray(b["row_id"]), np.asarray(b["label"]),
                    np.asarray(b["valid"]), px.copy()))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


# the iterator settings of tests/test_streaming.py
SETTINGS = {
    "drop_remainder": dict(canonical_size=32, batch_size=8, chunk_size=16,
                           seed=1),
    "keep_remainder": dict(canonical_size=32, batch_size=16, chunk_size=32,
                           drop_remainder=False, seed=2),
    "device_chunks": dict(canonical_size=24, batch_size=8, chunk_size=16,
                          shuffle=True, drop_remainder=False, seed=3),
}


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_batches_match_jax(tables, name):
    """Coverage with and without the remainder, and the JAX device-chunk
    setting: every batch equal to the JAX iterator's, over two epochs."""
    kw = SETTINGS[name]
    port_it, jax_it = _port(tables[0], **kw), _jax(tables[1], **kw)
    for _ in range(2):
        got = _epoch(port_it, True)
        _assert_same(got, _epoch(jax_it, False))
    assert len(port_it) == len(jax_it)
    seen = sorted(int(r) for rid, _, vd, _ in got for r in rid[vd])
    assert seen == list(range(40))
    if kw.get("drop_remainder", True):
        assert len(port_it) == 5 and all(vd.all() for _, _, vd, _ in got)
    else:  # the cohort's last partial batch pads with inert rows
        rid, lab, vd, _ = got[-1]
        assert (rid[~vd] == -1).all() and (lab[~vd] == 0).all()


def test_epochs_reshuffle(tables):
    kw = dict(canonical_size=32, batch_size=8, chunk_size=40, seed=3)
    it, jit = _port(tables[0], **kw), _jax(tables[1], **kw)
    e1, e2 = (np.concatenate([np.asarray(b["row_id"]) for b in it])
              for _ in range(2))
    j1, j2 = (np.concatenate([np.asarray(b["row_id"]) for b in jit])
              for _ in range(2))
    assert not np.array_equal(e1, e2)
    np.testing.assert_array_equal(e1, j1)
    np.testing.assert_array_equal(e2, j2)


def test_pixels_match_direct_decode(tables):
    store = HostImageStore(tables[0], canonical_size=32, workers=2)
    kw = dict(canonical_size=32, batch_size=8, chunk_size=16, shuffle=False,
              seed=0)
    first = next(iter(_port(tables[0], **kw)))
    rows = np.asarray(first["row_id"])
    np.testing.assert_array_equal(batch_pixels(first).numpy(),
                                  store.images[rows])
    jfirst = next(iter(_jax(tables[1], **kw)))
    np.testing.assert_array_equal(
        batch_pixels(first).permute(0, 2, 3, 1).numpy(),
        np.asarray(jfirst["pixels"]))
    # the chunk rides as one planar arena; the batch names its rows
    assert first["arena"].shape == (16, 3, 32, 32)
    assert first["rows"].tolist() == list(range(8))


def test_chunk_batch_divisibility_enforced(tables):
    for cls, table in ((tstreaming.ChunkedBatchIterator, tables[0]),
                       (jstreaming.ChunkedBatchIterator, tables[1])):
        with pytest.raises(ValueError, match="multiple"):
            cls(table, batch_size=7, chunk_size=16)


def _cached(table, cache, port=True):
    kw = dict(canonical_size=24, batch_size=8, chunk_size=16, shuffle=False,
              drop_remainder=False, seed=0, cache_path=cache)
    return _port(table, **kw) if port else _jax(table, **kw)


def test_stream_cache_roundtrip(tables, tmp_path, monkeypatch):
    """Epoch 1 decodes and fills the memmap, epoch 2 reads it and
    decodes nothing, a fresh iterator picks it up from the flag; the
    frames equal the JAX iterator's."""
    cache = str(tmp_path / "cache.npy")
    it = _cached(tables[0], cache)
    epoch1 = _epoch(it, True)
    assert it._cache_ready.all() and os.path.exists(cache + ".ready")
    assert (it.frames_decoded, it.frames_cached) == (40, 0)
    monkeypatch.setattr(tstreaming, "decode_image", lambda *a, **k: (
        _ for _ in ()).throw(AssertionError("decoded during cached epoch")))
    _assert_same(_epoch(it, True), epoch1)
    assert (it.frames_decoded, it.frames_cached) == (40, 40)
    assert _cached(tables[0], cache)._cache_ready.all()
    _assert_same(epoch1, _epoch(_cached(tables[1], str(tmp_path / "j.npy"),
                                        port=False), False))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_is_shared_across_the_packages(tables, tmp_path, monkeypatch,
                                             writer):
    """A cache one package wrote (the JAX layout: HWC frames, the same
    file and sidecars) is read by the other without a decode, and yields
    the same batches."""
    cache = str(tmp_path / "stream_cache_train_24.npy")
    first = _cached(tables[writer == "jax"], cache, port=writer == "port")
    want = _epoch(first, writer == "port")
    reader_port = writer == "jax"

    def poison(*a, **k):
        raise AssertionError("decoded a cached frame")

    monkeypatch.setattr(tstreaming, "decode_image", poison)
    monkeypatch.setattr(jstreaming, "decode_image", poison)
    reader = _cached(tables[not reader_port], cache, port=reader_port)
    assert reader._cache_ready.all()
    _assert_same(_epoch(reader, reader_port), want)


def test_stream_cache_remembers_corrupt_rows_across_processes(
    synth_root, tmp_path,
):
    """A ready cache keeps which rows were corrupt (zero-filled): a fresh
    iterator, the --auto-resume restart path, serves them invalid, as the
    JAX iterator does."""
    root = tmp_path / "stream_corrupt_root"
    shutil.copytree(synth_root, root)
    port_table, jax_table = _tables(str(root))
    victim = os.path.basename(port_table.file_paths()[3])
    (root / victim).write_bytes(b"definitely not a jpeg")
    victim_rows = {i for i, p in enumerate(port_table.file_paths())
                   if p.endswith(victim)}

    def invalid(it):
        bad = set()
        for b in it:
            rid, vd = np.asarray(b["row_id"]), np.asarray(b["valid"])
            bad.update(int(r) for r in rid[(~vd) & (rid >= 0)])
        return bad

    cache = str(tmp_path / "stream_corrupt.npy")
    with pytest.warns(UserWarning, match="failed to decode"):
        assert invalid(_cached(port_table, cache)) == victim_rows
    assert os.path.exists(cache + ".ready") and os.path.exists(cache + ".bad")
    fresh = _cached(port_table, cache)
    assert fresh._cache_ready.all()
    assert invalid(fresh) == victim_rows
    with pytest.warns(UserWarning, match="failed to decode"):
        assert invalid(_cached(jax_table, str(tmp_path / "j.npy"),
                               port=False)) == victim_rows


def test_stream_cache_without_bad_sidecar_is_distrusted(tables, tmp_path):
    """A .ready flag without the .bad sidecar cannot prove which zero
    frames were corrupt: the cache is decoded again and rewritten."""
    cache = str(tmp_path / "legacy_cache.npy")
    for _ in _cached(tables[0], cache):
        pass
    os.remove(cache + ".bad")
    it = _cached(tables[0], cache)
    assert not it._cache_ready.any()
    for _ in it:
        pass
    assert os.path.exists(cache + ".bad") and it._cache_ready.all()
    assert it.frames_decoded == 40


def test_missing_decoder_is_no_bad_file(tables, monkeypatch):
    """An ImportError (no decoder package, and no libjpeg decoder built)
    raises in the consumer instead of zero-filling the cohort."""
    def missing(*a, **k):
        raise ImportError("no decoder")

    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tstreaming, "decode_image", missing)
    with pytest.raises(ImportError, match="no decoder"):
        next(iter(_port(tables[0], canonical_size=24, batch_size=8,
                        chunk_size=16)))

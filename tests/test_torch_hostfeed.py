"""The host-batch feed, on the CPU: the port's ``BatchIterator`` against
the JAX package's (order, padding, ``valid`` and ``row_id``), whole runs
of each package with the arenas kept on the host (per-step losses to
rtol 1e-4, equal records), the port's host-fed and arena-fed runs step for
step with augment and dropout on, a split whose arena upload runs out of
device memory, and errors of the prefetch thread."""

import contextlib
import io

import numpy as np
import pytest
import torch

from skin_image_analysis_tpu.data import loader as jloader
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.data import loader as tloader
from skin_image_analysis_tpu_torch.train import loop as tloop
from tests.test_torch_cli import TIMES, _records
from tests.test_torch_optim import check_paired, cohort, paired_runs  # noqa: F401
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _Table:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, 2, n).astype(np.int32)
        self.row_ids = np.arange(n, dtype=np.int32)


class _Store:
    """What both packages' ``BatchIterator`` read of a store: planar
    images, the table, the rows whose decode failed."""

    def __init__(self, n=11, seed=0, bad=(3,)):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 3, 6, 6), dtype=np.uint8)
        self.table = _Table(n, seed)
        self.bad_rows = list(bad)

    def __len__(self):
        return len(self.images)

    @property
    def row_ok(self):
        ok = np.ones(len(self), bool)
        ok[self.bad_rows] = False
        return ok


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("drop", [False, True], ids=["pad", "drop"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["order", "shuffle"])
def test_batches_match_jax(shuffle, drop, prefetch):
    """Two epochs of batches: the same pixels, labels, row ids and valid
    flags as the JAX package's iterator, a short last batch padded (row
    id -1, invalid) or dropped, the bad row invalid."""
    store = _Store()
    kw = dict(shuffle=shuffle, drop_remainder=drop, seed=5)
    theirs = jloader.BatchIterator(store, 4, prefetch=0, **kw)
    mine = tloader.BatchIterator(store, 4, device="cpu", prefetch=prefetch,
                                 **kw)
    assert len(mine) == len(theirs) == (2 if drop else 3)
    seen_bad = False
    for _ in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == len(mine)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"pixels", "label", "row_id", "valid"}
            assert g["pixels"].dtype == torch.uint8
            assert g["pixels"].shape == (4, 3, 6, 6)
            for key in g:
                np.testing.assert_array_equal(g[key].numpy(),
                                              np.asarray(w[key]), key)
            seen_bad |= bool((g["row_id"] == 3).any())
    last = got[-1]
    if not drop:
        assert last["row_id"].tolist()[-1] == -1
        assert not last["valid"][-1]
    if seen_bad:
        rows = torch.cat([b["row_id"] for b in got])
        valid = torch.cat([b["valid"] for b in got])
        assert not valid[rows == 3].any()


def test_iterator_needs_an_explicit_device():
    with pytest.raises(TypeError, match="device"):
        tloader.BatchIterator(_Store(), 4)


def test_prefetch_error_reaches_the_consumer():
    """A gather that fails in the prefetch thread raises in the loop that
    consumes the batches; a consumer that stops early leaves no thread
    running."""
    store = _Store(n=9)
    store.table.labels = store.table.labels[:5]  # rows 5.. have no label
    it = tloader.BatchIterator(store, 4, device="cpu", shuffle=False,
                               prefetch=2)
    with pytest.raises(IndexError):
        for _ in it:
            pass
    import threading

    before = threading.active_count()
    ok = tloader.BatchIterator(_Store(n=40), 4, device="cpu", prefetch=1)
    for _ in ok:
        break
    assert threading.active_count() == before


@pytest.mark.parametrize("data", [
    dict(device_cache=False),
    dict(device_cache_max_bytes=1000),
], ids=["device_cache_off", "arenas_too_big"])
def test_host_fed_run_matches_jax(cohort, tmp_path, data):  # noqa: F811
    """Both packages feed host batches, one step a batch: the same
    per-step losses and records."""
    runs = paired_runs(tmp_path, cohort, data=data)
    assert len(runs["port_losses"]) >= 20
    check_paired(runs)


def _port_run(cohort, tmp_path, sub, verbose=False, **data):  # noqa: F811
    """A port run with augment (the preprocess kernel's path) and dropout,
    recording (loss, count) per step."""
    cfg = tconfig.TrainConfig(
        epochs=2, results_dir=str(tmp_path / sub), seed=0,
        data=tconfig.DataConfig(root_dir=cohort, image_size=24,
                                canonical_size=32, batch_size=8,
                                balance=False, augment=True,
                                decode_workers=2, prefetch_depth=2,
                                steps_per_dispatch=2, **data),
        model=tconfig.ModelConfig(conv_features=(8, 16),
                                  linear_features=(16,), dropout=(0.2,),
                                  image_size=24, compute_dtype="float32"),
        optim=tconfig.OptimConfig(learning_rate=1e-3))
    steps = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("multi_train_step", "train_step"):
            def wrap(step):
                def call(*a, **kw):
                    m = step(*a, **kw)
                    steps.append((m["loss"].reshape(-1),
                                  m["count"].reshape(-1)))
                    return m
                return call
            mp.setattr(tloop, name, wrap(getattr(tloop, name)))
        folder = tloop.run_training(cfg, verbose=verbose, device="cpu")
    losses = torch.cat([lo for lo, _ in steps])
    counts = torch.cat([c for _, c in steps])
    records = _records(folder)
    for r in records:
        for k in TIMES:
            r.pop(k)
    return losses[counts > 0], counts[counts > 0], records


@pytest.mark.parametrize("drop", [True, False], ids=["drop", "pad"])
def test_host_feed_equals_arena_feed(cohort, tmp_path, drop):  # noqa: F811
    """With augment and dropout on, the host-fed run draws what the
    arena-fed run draws, step for step: per-step losses to 1e-6, equal
    counts and records."""
    arena = _port_run(cohort, tmp_path, "arena", drop_remainder=drop)
    host = _port_run(cohort, tmp_path, "host", drop_remainder=drop,
                     device_cache=False)
    assert len(host[0]) == len(arena[0]) >= 10
    torch.testing.assert_close(host[0], arena[0], rtol=0, atol=1e-6)
    assert torch.equal(host[1], arena[1])
    assert host[2] == arena[2]


def test_upload_out_of_memory_feeds_that_split_from_the_host(
        cohort, tmp_path, monkeypatch):  # noqa: F811
    """An arena upload that runs out of device memory: that split takes
    host batches, says so, and the run trains as it would have."""
    arena = _port_run(cohort, tmp_path, "arena")
    upload = tloader.HostImageStore.to_device
    sizes = []

    def test_split_fails(self, device):
        sizes.append(len(self))
        if len(sizes) == 2:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return upload(self, device)

    monkeypatch.setattr(tloader.HostImageStore, "to_device",
                        test_split_fails)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fell_back = _port_run(cohort, tmp_path, "fallback", verbose=True)
    assert "'test' arena does not fit" in out.getvalue()
    torch.testing.assert_close(fell_back[0], arena[0], rtol=0, atol=0)
    assert fell_back[2] == arena[2]


def test_host_feed_with_eval_every_two(cohort, tmp_path):  # noqa: F811
    """Host batches on a run that evaluates every other epoch: records on
    those epochs only, progress on every one."""
    cfg = tconfig.TrainConfig(
        epochs=2, eval_every=2, results_dir=str(tmp_path / "r"), seed=0,
        checkpoint_every=1,
        data=tconfig.DataConfig(root_dir=cohort, image_size=32,
                                canonical_size=32, batch_size=8,
                                balance=False, device_cache=False,
                                decode_workers=2),
        model=tconfig.ModelConfig(conv_features=(8, 16),
                                  linear_features=(16,), dropout=(0.2,),
                                  image_size=32, compute_dtype="float32"))
    folder = tloop.run_training(cfg, verbose=False, device="cpu")
    assert [r["epoch"] for r in _records(folder)] == [1]
    assert tloop.completed_epochs(folder) == 2

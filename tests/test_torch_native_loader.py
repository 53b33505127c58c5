"""The port's libjpeg decoder (``data.native_loader``, ``csrc/decoder.cc``)
against the JAX package's, on the CPU: byte-equal arenas in both layouts
at every DCT denominator, an upscale and a grayscale frame; the same
reported failures and the same errors; ``HostImageStore`` on JPEG, mixed
and DICOM cohorts; a failed build; and the decoder linked against PIL's
bundled libjpeg-turbo.

Each case skips where the JAX decoder itself cannot be built (as
``tests/test_loader.py`` does), since there is then nothing to hold the
port against."""

import os
import shutil
import time

import numpy as np
import pytest

from skin_image_analysis_tpu.data import dataset as jdataset
from skin_image_analysis_tpu.data import ingest as jingest
from skin_image_analysis_tpu.data import loader as jloader
from skin_image_analysis_tpu.data import native_loader as jnative
from skin_image_analysis_tpu_torch.data import dataset as tdataset
from skin_image_analysis_tpu_torch.data import ingest as tingest
from skin_image_analysis_tpu_torch.data import loader as tloader
from skin_image_analysis_tpu_torch.data import native_loader as tnative
from skin_image_analysis_tpu_torch.ops.kernels import build
from tests.fixtures import make_synthetic_dataset
from tests.test_torch_data import write_dicom_cohort, write_metadata

TARGET = 32
# (name, height, width): at a 32 target libjpeg decodes the 40s at scale
# 1/1, the 80s at 1/2, the 160s at 1/4 and the 300s at 1/8, then box
# filters down; the 20x24 frame is resized up, the 32² one copied
SOURCES = (("d1", 40, 44), ("d2", 80, 72), ("d4", 160, 150),
           ("d8", 300, 310), ("d4_wide", 200, 300), ("up", 20, 24),
           ("same", 32, 32))


def jax_native_ready() -> bool:
    """Whether the JAX decoder loads in this process. Its first build at
    first use may race another test worker's, which can leave a library
    half written for a moment: that is retried."""
    for _ in range(20):
        try:
            return jnative.available()
        except OSError:
            time.sleep(0.5)
    return jnative.available()


def same_decoders(monkeypatch) -> None:
    """Both packages decode through their libjpeg decoders; where the JAX
    package's cannot be built, both through the python path."""
    if not jax_native_ready():
        monkeypatch.setattr(tnative, "available", lambda: False)


@pytest.fixture(autouse=True)
def _need_jax_decoder():
    if not jax_native_ready():
        pytest.skip("the JAX package's native decoder is not built")


def _frame(rng, h, w):
    """A smooth colour frame with some noise, as a photograph compresses."""
    import cv2

    small = rng.integers(0, 256, (max(h // 6, 2), max(w // 6, 2), 3),
                         dtype=np.uint8)
    img = cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)
    noise = rng.integers(-12, 13, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """{name: path} of the SOURCES, a grayscale JPEG, garbage bytes and a
    missing file."""
    import cv2

    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(18)
    paths = {}
    for name, h, w in SOURCES:
        paths[name] = str(root / f"{name}.jpg")
        cv2.imwrite(paths[name], _frame(rng, h, w))
    paths["gray"] = str(root / "gray.jpg")
    cv2.imwrite(paths["gray"], _frame(rng, 120, 90)[..., 0])
    paths["garbage"] = str(root / "garbage.jpg")
    with open(paths["garbage"], "wb") as f:
        f.write(b"these bytes are not a JPEG" * 8)
    paths["missing"] = str(root / "missing.jpg")
    return paths


def _arena(n, size, layout):
    shape = (n, size, size, 3) if layout == "hwc" else (n, 3, size, size)
    return np.full(shape, 7, np.uint8)


def _both(paths, size, layout, **kw):
    """The two packages' arenas and reports for ``paths``."""
    got, want = _arena(len(paths), size, layout), _arena(len(paths), size,
                                                         layout)
    got_failed = tnative.decode_batch_into(paths, got, on_error="report",
                                           **kw)
    want_failed = jnative.decode_batch_into(paths, want, on_error="report",
                                            **kw)
    return got, want, sorted(got_failed), sorted(want_failed)


@pytest.mark.parametrize("size", [TARGET, 24])
@pytest.mark.parametrize("layout", ["hwc", "planar"])
def test_decode_batch_into_matches_jax(jpegs, layout, size):
    """Every DCT denominator, an upscale, a copy and a grayscale frame,
    byte for byte, in the HWC and the planar arena."""
    names = [name for name, _, _ in SOURCES] + ["gray"]
    got, want, got_failed, want_failed = _both(
        [jpegs[n] for n in names], size, layout)
    assert got_failed == want_failed == []
    np.testing.assert_array_equal(got, want)
    gray = got[-1] if layout == "planar" else got[-1].transpose(2, 0, 1)
    assert (gray[0] == gray[1]).all() and (gray[1] == gray[2]).all()


def test_layouts_hold_the_same_pixels_on_any_thread_count(jpegs):
    paths = [jpegs[name] for name, _, _ in SOURCES]
    hwc = _arena(len(paths), TARGET, "hwc")
    planar = _arena(len(paths), TARGET, "planar")
    assert tnative.decode_batch_into(paths, hwc, n_threads=1) == len(paths)
    assert tnative.decode_batch_into(paths, planar, n_threads=5) == len(
        paths)
    np.testing.assert_array_equal(hwc.transpose(0, 3, 1, 2), planar)


def test_reported_failures_match_jax(jpegs):
    """A missing file and garbage bytes: the same slots reported, zero
    filled; the others decoded as the JAX package decodes them."""
    names = ["d2", "missing", "up", "garbage", "d8"]
    for layout in ("hwc", "planar"):
        got, want, got_failed, want_failed = _both(
            [jpegs[n] for n in names], TARGET, layout, n_threads=3)
        assert got_failed == want_failed == [1, 3]
        assert not got[[1, 3]].any()
        np.testing.assert_array_equal(got, want)


def test_raise_mode_raises_the_jax_ioerror(jpegs):
    paths = [jpegs["d1"], jpegs["garbage"], jpegs["missing"]]
    errors = []
    for module in (tnative, jnative):
        with pytest.raises(IOError) as e:
            module.decode_batch_into(paths, _arena(3, TARGET, "hwc"),
                                     n_threads=1)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("native decoder failed on 2/3 images")


@pytest.mark.parametrize("arena", [
    np.empty((1, 32, 32, 3), np.float32),
    np.empty((1, 32, 30, 3), np.uint8),
    np.empty((1, 4, 32, 32), np.uint8),
    np.empty((2, 32, 32, 3), np.uint8),
    np.empty((1, 32, 32, 3), np.uint8)[:, ::2],
], ids=["float", "not_square", "four_planes", "wrong_n", "strided"])
def test_bad_arena_raises_the_jax_valueerror(jpegs, arena):
    errors = []
    for module in (tnative, jnative):
        with pytest.raises(ValueError) as e:
            module.decode_batch_into([jpegs["d1"]], arena)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _cohort(root, kind):
    """A 24-row ISIC cohort: JPEGs with one corrupt file, JPEGs and
    DICOMs mixed, or DICOMs only."""
    if kind == "dicom":
        ids = write_metadata(root, 24, 5)
        write_dicom_cohort(root, 0, 32, 5, ids=ids[:12])
        write_dicom_cohort(root, 0, 48, 6, ids=ids[12:])
        return
    make_synthetic_dataset(root, n=24, seed=5, image_size=72)
    ids = [f"ISIC_{i:07d}" for i in range(24)]
    if kind == "jpeg":
        with open(os.path.join(root, f"{ids[3]}.jpg"), "wb") as f:
            f.write(b"corrupt")
    else:
        for isic_id in ids[::3]:
            os.remove(os.path.join(root, f"{isic_id}.jpg"))
        write_dicom_cohort(root, 0, 40, 5, ids=ids[::3])


def _stores(root, **kw):
    want = jloader.HostImageStore(
        jdataset.LesionTable(jingest.read_isic_metadata(root, seed=0), root),
        TARGET, workers=2, use_native=True, layout="planar")
    got = tloader.HostImageStore(
        tdataset.LesionTable(tingest.read_isic_metadata(root, seed=0), root),
        TARGET, workers=2, **kw)
    return got, want


@pytest.mark.parametrize("kind", ["jpeg", "mixed", "dicom"])
def test_host_image_store_matches_jax_native_store(tmp_path, kind):
    """The port's store on its decoder against the JAX package's planar
    store on its own: the same arena, byte for byte, and the same bad
    rows (a corrupt JPEG; the DICOM slots retried on the python path; an
    all-DICOM cohort, which skips the decoder)."""
    root = str(tmp_path)
    _cohort(root, kind)
    got, want = _stores(root)
    np.testing.assert_array_equal(got.images, want.images)
    assert got.bad_rows == sorted(want.bad_rows)
    table_ids = got.table.metadata.column("isic_id")
    if kind == "jpeg":
        assert [table_ids[i] for i in got.bad_rows] == ["ISIC_0000003"]
    else:
        assert got.bad_rows == []


def test_store_decodes_through_the_decoder(tmp_path, monkeypatch):
    """A JPEG cohort goes through ``decode_batch_into`` once, and only the
    reported slots through the python path."""
    root = str(tmp_path)
    _cohort(root, "mixed")
    calls, retried = [], []
    decode, one = tnative.decode_batch_into, tloader.decode_image
    monkeypatch.setattr(tnative, "decode_batch_into",
                        lambda *a, **k: calls.append(1) or decode(*a, **k))
    monkeypatch.setattr(tloader, "decode_image",
                        lambda p, s: retried.append(p) or one(p, s))
    got, _ = _stores(root)
    assert len(calls) == 1
    assert sorted(retried) == sorted(p for p in got.table.file_paths()
                                     if p.endswith(".dcm"))


def test_failed_build_is_remembered_and_the_store_falls_back(tmp_path,
                                                            monkeypatch):
    """No compiler: ``available()`` is False, the build is not tried
    again, and the store equals the JAX store with its decoder off."""
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no" / "g++"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_decoder", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    tries = []
    load_host = build.load_host
    monkeypatch.setattr(build, "load_host",
                        lambda *a: tries.append(1) or load_host(*a))
    assert tnative.available() is False
    assert tnative.available() is False and len(tries) == 1
    with pytest.raises(RuntimeError, match="previously failed"):
        tnative.decode_batch_into([], np.empty((0, 8, 8, 3), np.uint8))
    root = str(tmp_path / "cohort")
    _cohort(root, "jpeg")

    def off(*a, **k):
        raise RuntimeError("decoder off")

    monkeypatch.setattr(jnative, "decode_batch_into", off)
    got, want = _stores(root)
    np.testing.assert_array_equal(got.images, want.images)
    assert got.bad_rows == sorted(want.bad_rows) == [3]


def test_pillow_route_builds_and_matches_jax(jpegs, tmp_path, monkeypatch):
    """The decoder linked against the libjpeg-turbo of PIL's wheel and
    compiled against the vendored jpeg62 headers (the card machine's
    route, where no system libjpeg is installed)."""
    routes = [r for r in build.libjpeg_routes() if r[0] == "pillow"]
    if not routes:
        pytest.skip("PIL is not installed from a wheel that bundles libjpeg")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "libjpeg_routes", lambda: routes)
    monkeypatch.setattr(tnative, "_decoder", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    route, path = tnative.library()
    assert route == "pillow" and path.startswith(str(tmp_path))
    names = [name for name, _, _ in SOURCES] + ["gray", "garbage"]
    for layout in ("hwc", "planar"):
        got, want, got_failed, want_failed = _both(
            [jpegs[n] for n in names], TARGET, layout)
        assert got_failed == want_failed == [len(names) - 1]
        np.testing.assert_array_equal(got, want)


def test_library_is_named_by_its_source_route_and_libjpeg(tmp_path,
                                                         monkeypatch):
    """An edited source, another route or another libjpeg gets a library
    of its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "LIBJPEG_HEADERS",
                        csrc / "third_party" / "libjpeg")
    flags = ["-ljpeg"]
    before = {build.host_library_path("decoder", "system", flags),
              build.host_library_path("decoder", "pillow", flags),
              build.host_library_path("decoder", "system", ["x.so"])}
    assert len(before) == 3
    with open(csrc / "decoder.cc", "a") as f:
        f.write("\n")
    assert build.host_library_path("decoder", "system", flags) not in before

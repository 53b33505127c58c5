"""The shortest-side resize (the reference's ``Rescale(int)``, then the
centre square) of the port's ``data.loader`` against the JAX package's,
on the CPU: ``decode_image(mode="shortest")`` and
``HostImageStore(resize_mode="shortest")`` on a seeded cohort of
non-square JPEGs, PNGs and DICOMs, landscape and portrait, larger and
smaller than the canonical side, through cv2 and through PIL with cv2
blocked. Arenas are held byte for byte."""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from skin_image_analysis_tpu.data import dataset as jdataset
from skin_image_analysis_tpu.data import ingest as jingest
from skin_image_analysis_tpu.data import loader as jloader
from skin_image_analysis_tpu_torch.data import dataset as tdataset
from skin_image_analysis_tpu_torch.data import ingest as tingest
from skin_image_analysis_tpu_torch.data import loader as tloader
from tests.test_torch_data import make_explicit_rgb, write_metadata

SIZE = 24
# (height, width): landscape and portrait, down- and upscaled, and a
# shortest side already at SIZE (no resize, only the crop)
SHAPES = ((30, 44), (52, 36), (18, 26), (24, 40), (41, 17), (64, 48))
KINDS = (".jpg", ".png", ".dcm")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """36 rows: each row's file is a JPEG, a PNG or a DICOM of one of
    SHAPES, smooth gradients plus noise from a numpy seed."""
    root = str(tmp_path_factory.mktemp("shortest"))
    ids = write_metadata(root, 36, 8)
    rng = np.random.default_rng(8)
    for i, isic_id in enumerate(ids):
        h, w = SHAPES[i % len(SHAPES)]
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([yy * 200 // h, xx * 200 // w, (yy + xx) % 64 * 3],
                       -1) + rng.integers(0, 50, (h, w, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        ext = KINDS[(i // len(SHAPES)) % len(KINDS)]
        path = os.path.join(root, isic_id + ext)
        if ext == ".dcm":
            with open(path, "wb") as f:
                f.write(make_explicit_rgb(img))
        else:
            Image.fromarray(img).save(path, quality=90)
    return root


@pytest.fixture(params=["cv2", "pil"])
def decoder(request, monkeypatch):
    """cv2, or PIL with cv2 unimportable (both packages' fallback)."""
    if request.param == "pil":
        monkeypatch.setitem(sys.modules, "cv2", None)
    return request.param


def test_decode_image_shortest_matches_jax(cohort, decoder):
    names = sorted(os.listdir(cohort))
    paths = [os.path.join(cohort, n) for n in names
             if n.endswith(KINDS)]
    assert {os.path.splitext(p)[1] for p in paths} == set(KINDS)
    for path in paths:
        got = tloader.decode_image(path, SIZE, mode="shortest")
        want = jloader.decode_image(path, SIZE, mode="shortest")
        assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
        assert got.flags.c_contiguous
        np.testing.assert_array_equal(got, want, err_msg=path)
        # the square mode is another geometry on a non-square frame
        square = tloader.decode_image(path, SIZE)
        np.testing.assert_array_equal(square, jloader.decode_image(path,
                                                                   SIZE))


def test_host_image_store_shortest_arena_equals_jax(cohort, decoder):
    """The whole arena, byte-equal to JAX's planar store in shortest
    mode; the libjpeg decoder is skipped in both (it makes exact squares
    only), so ``use_native`` is left at its default. A bad mode raises."""
    jdf = jingest.read_isic_metadata(cohort, seed=0)
    want = jloader.HostImageStore(jdataset.LesionTable(jdf, cohort), SIZE,
                                  workers=2, layout="planar",
                                  resize_mode="shortest")
    table = tdataset.LesionTable(tingest.read_isic_metadata(cohort, seed=0),
                                 cohort)
    got = tloader.HostImageStore(table, SIZE, workers=2,
                                 resize_mode="shortest")
    assert got.resize_mode == "shortest" and got.bad_rows == []
    assert got.images.shape == want.images.shape == (len(table), 3, SIZE,
                                                     SIZE)
    np.testing.assert_array_equal(got.images, want.images)
    square = tloader.HostImageStore(table, SIZE, workers=2)
    assert not np.array_equal(square.images, got.images)
    with pytest.raises(ValueError, match="square|shortest"):
        tloader.HostImageStore(table, SIZE, resize_mode="longest")

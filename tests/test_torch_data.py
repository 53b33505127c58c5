"""The port's host data path (metadata, ingest, splits, LesionTable,
DICOM and image decode, HostImageStore) against the JAX package's, on the
CPU. Splits must give the same isic_id order, arenas the same bytes."""

import csv
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from skin_image_analysis_tpu.data import dataset as jdataset
from skin_image_analysis_tpu.data import dicom as jdicom
from skin_image_analysis_tpu.data import ingest as jingest
from skin_image_analysis_tpu.data import loader as jloader
from skin_image_analysis_tpu.data import metadata as jmetadata
from skin_image_analysis_tpu_torch.data import dataset as tdataset
from skin_image_analysis_tpu_torch.data import dicom as tdicom
from skin_image_analysis_tpu_torch.data import ingest as tingest
from skin_image_analysis_tpu_torch.data import loader as tloader
from skin_image_analysis_tpu_torch.data import metadata as tmetadata
from tests.fixtures import make_synthetic_dataset
from tests.test_dicom import (
    _el_explicit,
    _meta,
    _us,
    make_encapsulated_jpeg,
    make_explicit_mono16,
    make_implicit_rgb,
)
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")

FITZ = ("I", "II", "III", "IV", "V", "VI")
# every string pandas reads as missing, and some it keeps
NA_CELLS = ("", "NA", "N/A", "nan", "NaN", "null", "NULL", "None", "#N/A",
            "<NA>", "n/a", "-nan")


def make_explicit_rgb(arr: np.ndarray) -> bytes:
    """An RGB uint8 frame as explicit VR little endian native pixels."""
    rows, cols, _ = arr.shape
    body = b"".join([
        _el_explicit(0x0028, 0x0002, b"US", _us(3)),
        _el_explicit(0x0028, 0x0004, b"CS", b"RGB"),
        _el_explicit(0x0028, 0x0006, b"US", _us(0)),
        _el_explicit(0x0028, 0x0010, b"US", _us(rows)),
        _el_explicit(0x0028, 0x0011, b"US", _us(cols)),
        _el_explicit(0x0028, 0x0100, b"US", _us(8)),
        _el_explicit(0x0028, 0x0103, b"US", _us(0)),
        _el_explicit(0x7FE0, 0x0010, b"OB", arr.astype(np.uint8).tobytes()),
    ])
    return _meta("1.2.840.10008.1.2.1") + body


def write_metadata(root, n, seed, p_malignant=0.4, p_light=1 / 3,
                   na_every=7):
    """``metadata.csv`` of ``n`` ISIC rows: every ``na_every``-th row has a
    missing Fitzpatrick type (one of :data:`NA_CELLS`), some rows an
    indeterminate diagnosis or a missing sex; returns the isic_ids."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        if i % na_every == na_every - 1:
            fitz = NA_CELLS[(i // na_every) % len(NA_CELLS)]
        else:
            light = rng.random() < p_light
            fitz = FITZ[rng.integers(0, 2) if light else rng.integers(2, 6)]
        bm = ("indeterminate" if i % 11 == 10
              else "malignant" if rng.random() < p_malignant else "benign")
        rows.append({
            "isic_id": f"ISIC_{i:07d}", "attribution": "synthetic",
            "age_approx": "" if i % 5 == 4 else str(int(rng.integers(20, 90))),
            "anatom_site_general": "torso", "benign_malignant": bm,
            "diagnosis": "melanoma" if bm == "malignant" else "nevus",
            "fitzpatrick_skin_type": fitz,
            "patient_id": f"IP_{i % 7:07d}",
            "sex": ("NA" if i % 9 == 8
                    else "male" if rng.random() < 0.5 else "female"),
        })
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "metadata.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return [r["isic_id"] for r in rows]


def write_dicom_cohort(root, n, size, seed, ids=None):
    """Explicit VR RGB DICOMs of ``size``² for ``ids`` (else a fresh
    metadata.csv of ``n`` rows) under ``root``."""
    if ids is None:
        ids = write_metadata(root, n, seed)
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    for isic_id in ids:
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        with open(os.path.join(root, f"{isic_id}.dcm"), "wb") as f:
            f.write(make_explicit_rgb(img))
    return ids


def _ids(frame):
    if isinstance(frame, pd.DataFrame):
        return list(frame["isic_id"])
    return frame.column("isic_id")


def test_na_strings_are_pandas_defaults():
    from pandas._libs.parsers import STR_NA_VALUES

    assert tingest.NA_STRINGS == set(STR_NA_VALUES)


# (p_malignant, p_light): the usual majority benign and light, then a
# cohort whose minorities are benign and light
COHORTS = {"benign_light_majority": (0.3, 0.3),
           "benign_light_minority": (0.75, 0.15)}


@pytest.mark.parametrize("cohort", sorted(COHORTS))
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_ingest_balance_split_match_jax(tmp_path, cohort, seed):
    """Exact: the filtered rows, skin_tone, control, the balanced rows
    and both splits in the same isic_id order, and the counts."""
    p_mal, p_light = COHORTS[cohort]
    write_metadata(str(tmp_path), 150, seed, p_mal, p_light)
    want = jingest.read_isic_metadata(str(tmp_path), seed=seed)
    got = tingest.read_isic_metadata(str(tmp_path), seed=seed)
    assert _ids(got) == _ids(want)
    for col in ("skin_tone", "control", "benign_malignant"):
        assert got.column(col) == list(want[col])
    counts = jingest.print_counts(want)
    if cohort == "benign_light_minority":
        bm, tone = counts["benign_malignant"], counts["skin_tone"]
        assert bm["benign"] < bm["malignant"]
        assert tone["light"] < tone["dark"]
    assert tingest.print_counts(got) == counts

    want_b = jingest.balance_dataset(want, seed=seed, verbose=False)
    got_b = tingest.balance_dataset(got, seed=seed, verbose=False)
    assert _ids(got_b) == _ids(want_b)
    for ratio in (0.7, 0.5):
        want_tr, want_te = jingest.shuffle_split(want_b, ratio, seed=seed)
        got_tr, got_te = tingest.shuffle_split(got_b, ratio, seed=seed)
        assert _ids(got_tr) == _ids(want_tr)
        assert _ids(got_te) == _ids(want_te)


def test_split_csvs_read_back_in_both_packages(tmp_path):
    """A split CSV written by either package reads back in the other with
    the same rows in the same order and the same label and group codes.
    The files differ in one way only: pandas writes a numeric column that
    has a missing cell as floats (age 55 as 55.0); the port keeps the
    text it read."""
    write_metadata(str(tmp_path), 90, 3)
    jdf = jingest.shuffle_split(jingest.read_isic_metadata(
        str(tmp_path), seed=3), seed=3)[0]
    tdf = tingest.shuffle_split(tingest.read_isic_metadata(
        str(tmp_path), seed=3), seed=3)[0]
    jdf.to_csv(tmp_path / "jax.csv")
    tdf.to_csv(str(tmp_path / "port.csv"))
    from_jax = tingest.read_csv(str(tmp_path / "jax.csv"), index_col=True)
    from_port = pd.read_csv(tmp_path / "port.csv", index_col=0)
    assert from_jax.columns == list(jdf.columns) == list(from_port.columns)
    pd.testing.assert_frame_equal(from_port, pd.read_csv(
        tmp_path / "jax.csv", index_col=0))
    ages = from_jax.column("age_approx")
    assert any(a and a.endswith(".0") for a in ages)
    assert [a and a.removesuffix(".0") for a in ages] == \
        tdf.column("age_approx")
    for frame in (from_jax, tdf):
        got = tdataset.LesionTable(frame, str(tmp_path))
        want = jdataset.LesionTable(jdf, str(tmp_path))
        np.testing.assert_array_equal(got.labels, want.labels)
        assert got.group_codes.keys() == want.group_codes.keys()
        for col in want.group_codes:
            np.testing.assert_array_equal(got.group_codes[col],
                                          want.group_codes[col])
        assert (got.group_codes["sex"] == -1).any()


def test_lesion_table_matches_jax(tmp_path):
    write_metadata(str(tmp_path), 40, 5)
    jdf = jingest.read_isic_metadata(str(tmp_path), seed=5)
    tdf = tingest.read_isic_metadata(str(tmp_path), seed=5)
    ids = list(jdf["isic_id"])
    for isic_id, ext in zip(ids[:4], (".jpeg", ".png", ".dcm", ".jpg")):
        open(tmp_path / f"{isic_id}{ext}", "wb").close()
    want = jdataset.LesionTable(jdf, str(tmp_path))
    got = tdataset.LesionTable(tdf, str(tmp_path))
    np.testing.assert_array_equal(got.row_ids, want.row_ids)
    assert got.file_paths() == want.file_paths()
    assert got.file_paths()[:4] == [
        str(tmp_path / f"{i}{e}") for i, e in
        zip(ids, (".jpeg", ".png", ".dcm", ".jpg"))]
    for idx in (0, 3, len(ids) - 1):
        a, b = got.instance(idx), want.instance(idx)
        assert a.keys() == b.keys()
        for key in ("file_path", "image_name", "benign_malignant",
                    "skin_type", "skin_tone", "control", "diagnosis"):
            assert a[key] == b[key], key
    assert got.instances_for([1, 2]).keys() == {1, 2}
    with pytest.raises(ValueError, match="unknown benign_malignant"):
        tdataset.LesionTable(tingest.read_csv(
            str(tmp_path / "metadata.csv")), str(tmp_path))


def test_metadata_table_matches_jax(tmp_path):
    write_metadata(str(tmp_path), 30, 2)
    path = str(tmp_path / "metadata.csv")
    want, got = jmetadata.read_metadata_csv(path), \
        tmetadata.read_metadata_csv(path)
    for fn in ("report_attribution", "report_skin_types",
               "report_tone_diagnosis_grid"):
        assert getattr(tmetadata, fn)(got) == getattr(jmetadata, fn)(want)
    assert {k: len(v) for k, v in got.partition("sex").items()} == \
        {k: len(v) for k, v in want.partition("sex").items()}


@pytest.mark.parametrize("make", [
    lambda a: make_explicit_rgb(a),
    lambda a: make_implicit_rgb(a),
    lambda a: make_explicit_mono16(a[..., 0].astype(np.uint16) * 200),
    lambda a: make_encapsulated_jpeg(a),
], ids=["explicit_rgb", "implicit_rgb", "explicit_mono16", "jpeg"])
def test_dicom_decode_matches_jax(tmp_path, make):
    rng = np.random.default_rng(4)
    img = rng.integers(10, 240, (12, 16, 3), dtype=np.uint8)
    path = str(tmp_path / "x.dcm")
    with open(path, "wb") as f:
        f.write(make(img))
    got, want = tdicom.read_dicom_image(path), jdicom.read_dicom_image(path)
    assert got.dtype == np.uint8 and got.shape == (12, 16, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["jpeg_cv2", "jpeg_pil", "dicom"])
def test_host_image_store_arena_equals_jax(tmp_path, monkeypatch, kind):
    """Byte-equal planar arenas on the python path (both stores with
    ``use_native=False``): JPEGs resized 40 -> 32 through cv2, and
    through PIL where cv2 cannot be imported (as in the JAX package's
    python path), and DICOMs at the canonical size and resized 24 -> 32;
    a missing file is zero-filled and reported the same way."""
    root = str(tmp_path)
    if kind == "jpeg_pil":
        monkeypatch.setitem(sys.modules, "cv2", None)
    if kind != "dicom":
        make_synthetic_dataset(root, n=24, seed=2, image_size=40)
    else:
        ids = write_metadata(root, 24, 2)
        write_dicom_cohort(root, 0, 32, 2, ids=ids[:12])
        write_dicom_cohort(root, 0, 24, 3, ids=ids[12:])
    jdf = jingest.read_isic_metadata(root, seed=0)
    os.remove(jdataset.LesionTable(jdf, root).file_paths()[1])
    want = jloader.HostImageStore(jdataset.LesionTable(jdf, root), 32,
                                  workers=2, use_native=False,
                                  layout="planar")
    got = tloader.HostImageStore(tdataset.LesionTable(
        tingest.read_isic_metadata(root, seed=0), root), 32, workers=2,
        use_native=False)
    assert got.images.shape == want.images.shape
    np.testing.assert_array_equal(got.images, want.images)
    assert got.bad_rows == want.bad_rows == [1]
    assert not got.row_ok[1] and got.row_ok.sum() == len(got) - 1
    arena = got.to_device("cpu")
    assert arena.dtype == torch.uint8 and torch.equal(
        arena, torch.from_numpy(want.images))


def test_decode_and_rescale_match_jax(tmp_path):
    """A JPEG decoded and resized 48 -> 20, and rescale_image's own cases:
    the shortest side, an exact size, a frame already at its size."""
    make_synthetic_dataset(str(tmp_path), n=3, seed=1, image_size=48)
    path = str(tmp_path / "ISIC_0000000.jpg")
    np.testing.assert_array_equal(tloader.decode_image(path, 20),
                                  jloader.decode_image(path, 20))
    img = np.random.default_rng(0).integers(0, 256, (30, 40, 3), np.uint8)
    assert tloader.rescale_image(img, (30, 40)) is img
    for size in (20, (25, 35), 60):
        np.testing.assert_array_equal(tloader.rescale_image(img, size),
                                      jloader.rescale_image(img, size))

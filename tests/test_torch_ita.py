"""The port's ITA path (``data/ita.py``), the modal-ITA classifiers
(``toneclassifier/classical.py``), the transfer trainer's ITA input and
the ``images_to_ita`` CLI, against the JAX package's on the CPU, from the
same numpy-seeded inputs."""

import csv
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu.cli import images_to_ita as jcli
from skin_image_analysis_tpu.data import ita as jita
from skin_image_analysis_tpu.ops import preprocess as jpre
from skin_image_analysis_tpu.toneclassifier.classical import (
    ModalItaClassifier as JModalItaClassifier,
)
from skin_image_analysis_tpu_torch.cli import images_to_ita as tcli
from skin_image_analysis_tpu_torch.data import ita as tita
from skin_image_analysis_tpu_torch.ops import preprocess as tpre
from skin_image_analysis_tpu_torch.toneclassifier import ModalItaClassifier
from skin_image_analysis_tpu_torch.train import classify as tclassify
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")

# light (ITA about 47) and dark (about -14) skin colours
SKIN = {"light": (215, 170, 140), "dark": (130, 88, 62)}


def skin_frames(rng, n: int, size: int, noise: int = 12) -> np.ndarray:
    """uint8 ``[n, size, size, 3]``: alternately light and dark skin with
    ``noise`` per channel, so that most pixels fall in the skin gamut and
    some (the noisiest) outside it."""
    base = np.array([SKIN["light" if i % 2 == 0 else "dark"]
                     for i in range(n)])[:, None, None, :]
    img = base + rng.integers(-noise, noise + 1, (n, size, size, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_skin_jpegs(root: str, seed: int, size: int = 64,
                     noise: int = 12) -> None:
    """Replace each ``<isic_id>.jpg`` of a cohort's ``metadata.csv`` by a
    skin-coloured frame, light for benign rows and dark for the others,
    with ``noise`` per channel."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    with open(os.path.join(root, "metadata.csv"), newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        tone = "light" if row["benign_malignant"] == "benign" else "dark"
        img = np.array(SKIN[tone]) + rng.integers(-noise, noise + 1,
                                                  (size, size, 3))
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(root, f"{row['isic_id']}.jpg"), quality=90)


def _lab64(rgb01: np.ndarray) -> np.ndarray:
    """The same formulas in float64, to measure how far a pixel lies from
    the skin gamut's bounds."""
    lin = np.where(rgb01 > 0.04045, ((rgb01 + 0.055) / 1.055) ** 2.4,
                   rgb01 / 12.92)
    m = np.array([[0.4124564, 0.3575761, 0.1804375],
                  [0.2126729, 0.7151522, 0.0721750],
                  [0.0193339, 0.1191920, 0.9503041]])
    t = lin @ m.T / np.array([0.95047, 1.0, 1.08883])
    f = np.where(t > 0.008856, np.cbrt(t), (903.3 * t + 16.0) / 116.0)
    return np.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]),
                     200 * (f[..., 1] - f[..., 2])], -1)


def test_srgb_to_lab_matches_jax():
    """Within 1e-4 over [0, 1] with the values at and around the linear
    segment's end (0.04045) and the clip."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.1, 1.1, (4, 16, 16, 3)).astype(np.float32)
    x[0, 0, :4] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.04045] * 3,
                   [0.04045, 0.5, 1.0]]
    want = np.asarray(jita.srgb_to_lab(jnp.asarray(x)))
    got = tita.srgb_to_lab(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_cube_root_by_pow_is_within_two_ulps_of_cbrt():
    """The port's ``t ** (1/3)`` on the branch ``t > 0.008856`` against a
    correctly rounded float32 cube root, over the branch's whole range of
    ``t`` (up to 1.09, the white point's largest ratio): measured at most
    1 ulp."""
    t = np.linspace(0.008857, 1.09, 200_001, dtype=np.float32)
    want = np.cbrt(t.astype(np.float64)).astype(np.float32)
    got = (torch.from_numpy(t) ** (1.0 / 3.0)).numpy()
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 2, ulps.max()


def test_ita_matrix_matches_jax():
    """uint8 and float input. Where both packages call a pixel skin, the
    angles agree within 1e-3 degrees; the masks differ only at pixels whose
    float64 Lab lies within 1e-4 of a gamut bound."""
    rng = np.random.default_rng(1)
    u8 = skin_frames(rng, 6, 24, noise=25)
    for x in (u8, u8.astype(np.float32) / 255.0):
        want = np.asarray(jita.ita_matrix(jnp.asarray(x)))
        got = tita.ita_matrix(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == u8.shape[:3]
        both = ~np.isnan(got) & ~np.isnan(want)
        assert 0.2 < both.mean() < 0.9
        np.testing.assert_allclose(got[both], want[both], atol=1e-3, rtol=0)
        lab = _lab64(u8.astype(np.float64) / 255.0)
        bounds = np.abs(lab[..., :, None] - np.array(
            [[30, 80], [0, 20], [5, 25]])[None, None, None]).min(-1).min(-1)
        differ = np.isnan(got) != np.isnan(want)
        assert (bounds[differ] < 1e-4).all()


def test_ita_to_fitzpatrick_and_tone_match_jax():
    """Equal bands at, just below and away from each threshold, and for
    NaN (0); equal binary tones."""
    t = np.array(tita.FITZ_THRESHOLDS, np.float32)
    ita = np.concatenate([t, np.nextafter(t, -np.inf), t + 3, [-89.0, 89.0,
                                                               np.nan]])
    ita = ita.astype(np.float32).reshape(1, 1, -1)
    got = tita.ita_to_fitzpatrick(torch.from_numpy(ita))
    want = np.asarray(jita.ita_to_fitzpatrick(jnp.asarray(ita)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(set(want.ravel())) == [0, 1, 2, 3, 4, 5, 6]
    assert jita.FITZ_THRESHOLDS == tita.FITZ_THRESHOLDS


def _centres(rng, shape, n_bins=90):
    """ITA values near bin centres (never within 0.2 degrees of a bin
    edge)."""
    bins = rng.integers(0, n_bins, shape)
    return (-90.0 + (bins + 0.5 + rng.uniform(-0.4, 0.4, shape))
            * (180.0 / n_bins)).astype(np.float32)


def test_modal_ita_matches_jax():
    """Equal on values away from bin edges with NaN (non-skin) pixels, on
    the range's ends (-90 and 90), on tied bins (the first wins) and on an
    image with no skin (NaN); ``image_tone_binary`` equal."""
    rng = np.random.default_rng(2)
    ita = _centres(rng, (5, 12, 12))
    ita[rng.random(ita.shape) < 0.3] = np.nan
    ita[0, 0, :3] = [-90.0, 90.0, 90.0]
    ita[1] = np.nan                                   # no skin
    ita[2] = np.nan
    ita[2, 0, :4] = [50.5, 20.5, 20.7, 50.3]          # tie: bins 55 and 70
    ita[3] = np.nan
    ita[3, 0, :2] = [-61.0, 61.0]                     # tie across tones
    for n_bins in (90, 45):
        want = np.asarray(jita.modal_ita(jnp.asarray(ita), n_bins=n_bins))
        got = tita.modal_ita(torch.from_numpy(ita), n_bins=n_bins).numpy()
        np.testing.assert_array_equal(got, want)
    got = tita.modal_ita(torch.from_numpy(ita)).numpy()
    assert np.isnan(got[1]) and got[2] == 21.0 and got[3] == -61.0
    np.testing.assert_array_equal(
        tita.image_tone_binary(torch.from_numpy(ita)).numpy(),
        np.asarray(jita.image_tone_binary(jnp.asarray(ita))))


def test_ita_input_and_pipeline_match_jax():
    """``ita_input`` (and its planar form) within 1e-5; ``ita_pipeline``'s
    ITA within 1e-3 degrees where both call a pixel skin, NaN where both
    do not, its bands, modal ITAs and tones equal."""
    rng = np.random.default_rng(3)
    u8 = skin_frames(rng, 4, 20)
    x = u8.astype(np.float32) / 255.0
    want = np.asarray(jita.ita_input(jnp.asarray(x)))
    got = tita.ita_input(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 20, 20, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    planar = tita.ita_input_planar(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(planar.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)
    jout = jita.ita_pipeline(jnp.asarray(u8))
    tout = tita.ita_pipeline(torch.from_numpy(u8))
    assert sorted(tout) == sorted(jout)
    a, b = tout["ita"].numpy(), np.asarray(jout["ita"])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)], atol=1e-3,
                               rtol=0)
    for key in ("fitzpatrick", "modal_ita", "tone"):
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]))
    assert tout["tone"].tolist() == [0, 1, 0, 1]


@pytest.mark.parametrize("mode", ["threshold", "logistic", "svm"])
def test_modal_ita_classifier_matches_jax(mode):
    """The threshold equal; the logistic and svm coefficients within 1e-4
    relative (both fit in float32: 500 steps of 0.1 and 2,000 of 0.05);
    the predictions and scores equal, NaN features predicting dark.

    The logistic fit is held on the features in units of 20 degrees. On
    degree-scale features its plain gradient descent (lr 0.1 on the raw
    feature, as in the JAX package) does not converge: the step times the
    loss's curvature, about 0.1 * mean(x^2) / 4, is far above 2, and the
    sigmoid saturates. Its coefficients there are rounding noise in
    either package: the same 500 steps in numpy end at w = -0.53 in
    float32 and -0.79 in float64 on this data. svm standardizes the
    feature first."""
    rng = np.random.default_rng(4)
    tone = (rng.random(120) < 0.6).astype(np.int32)
    x = np.where(tone == 1, rng.normal(20, 12, 120), rng.normal(45, 9, 120))
    x[rng.random(120) < 0.05] = np.nan
    unit = 20.0 if mode == "logistic" else 1.0
    x = x / unit
    mine = ModalItaClassifier(mode).fit(x, tone)
    theirs = JModalItaClassifier(mode).fit(x, tone)
    if mode == "threshold":
        assert mine.threshold_ == theirs.threshold_
    else:
        np.testing.assert_allclose(mine.coef_, theirs.coef_, rtol=1e-4)
    probe = np.concatenate([x, np.linspace(-40, 80, 61) / unit, [np.nan]])
    np.testing.assert_array_equal(mine.predict(probe), theirs.predict(probe))
    assert mine.score(x, tone) == theirs.score(x, tone) > 0.7
    with pytest.raises(ValueError):
        ModalItaClassifier("forest")
    with pytest.raises(RuntimeError, match="fit first"):
        ModalItaClassifier(mode).predict(x)


def test_ita_train_input_through_the_kernel_path_matches_jax():
    """The ITA-mode train preprocess: crop 40 -> 32 and flip through the
    planar path that gathers rows (the kernel's plain twin on the CPU), on
    JAX's draws replayed, then the ITA channels: within 1e-5 of JAX's
    ``ita_input(preprocess_batch(...))``; the wrapper keeps ``rows=``."""
    b, s, t = 6, 40, 32
    rng = np.random.default_rng(5)
    arena = skin_frames(rng, 10, s).transpose(0, 3, 1, 2).copy()
    rows = np.array([3, 0, 9, 9, 5, 1], np.int32)
    key = jax.random.key(8)
    augment = jpre.AugmentConfig(random_crop=True, horizontal_flip=True)
    want = jita.ita_input(jpre.preprocess_batch(
        jnp.asarray(arena[rows].transpose(0, 2, 3, 1)), key, image_size=t,
        train=True, augment=augment))
    key, sub = jax.random.split(key)
    ky, kx = jax.random.split(sub)
    ys = jax.random.randint(ky, (b,), 0, s - t + 1)
    xs = jax.random.randint(kx, (b,), 0, s - t + 1)
    key, sub = jax.random.split(key)
    flips = jax.random.bernoulli(sub, 0.5, (b, 1, 1, 1)).reshape(b)
    draws = tpre.AugmentDraws(
        torch.from_numpy(np.stack([ys, xs], 1).astype(np.int32)),
        torch.from_numpy(np.asarray(flips).astype(np.int32)),
        None, None, None)

    def pre(pixels, generator=None, rows=None):
        return tpre.preprocess_planar_batch(
            pixels, image_size=t, train=True,
            augment=tpre.AugmentConfig(True, True), rows=rows, draws=draws)

    pre.supports_rows = True
    fn = tclassify._ita_wrap(pre)
    assert fn.supports_rows
    got = fn(torch.from_numpy(arena), None, rows=torch.from_numpy(rows))
    assert got.shape == (b, t, t, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _write_pngs(folder: str, seed: int) -> list[str]:
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    names = []
    for i, img in enumerate(skin_frames(rng, 5, 40)):
        names.append(f"img_{i}.png")
        cv2.imwrite(os.path.join(folder, names[-1]), img[:, :, ::-1])
    rng_img = rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)
    cv2.imwrite(os.path.join(folder, "grey.PNG"), rng_img)
    (open(os.path.join(folder, "notes.txt"), "w")).close()
    return names + ["grey.PNG"]


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_images_to_ita_cli_matches_jax(tmp_path, capsys):
    """PNGs (5 skin frames of 40² and one 50x30 frame) at ``--size 32``
    in batches of 4, the last padded: the same ``.npy`` names, each
    matrix's NaN pixels equal and its angles within 1e-3 degrees, the same
    summary CSV; a second run resumes with nothing to do."""
    src = str(tmp_path / "images")
    names = _write_pngs(src, 6)
    outs = {}
    for who, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / who)
        summary = str(tmp_path / f"{who}.csv")
        assert main([src, out, "--size", "32", "--batch-size", "4",
                     "--summary-csv", summary, *extra]) == 0
        text = capsys.readouterr().out
        assert text.startswith("6 images, 6 to process")
        outs[who] = (out, _read_csv(summary))
    (jout, jrows), (tout, trows) = outs["jax"], outs["port"]
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout)) == sorted(
        os.path.splitext(n)[0] + ".npy" for n in names)
    for name in os.listdir(jout):
        a = np.load(os.path.join(tout, name))
        b = np.load(os.path.join(jout, name))
        assert a.shape == b.shape == (32, 32) and a.dtype == b.dtype
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                   atol=1e-3, rtol=0)
    assert trows == jrows and len(trows) == 6
    assert tcli.main([src, tout, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("6 images, 0 to process")
    assert tcli.main([src]) == 1


def test_images_to_ita_without_a_decoder_names_cv2_and_pil(tmp_path,
                                                           monkeypatch):
    src = str(tmp_path / "images")
    _write_pngs(src, 7)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="cv2.*PIL|PIL.*cv2"):
        tcli.main([src, str(tmp_path / "out"), "--device", "cpu"])

"""The public names the port lacked until the name-level check of
``tests/test_torch_exports.py`` (``LesionTable.get_class_names`` and
``get_class``, ``BatchIterator.super_batches``,
``ArrayDataset.device_pixels``, ``dequantize_weights``,
``space_to_depth_nhwc``, the kernels modules' ``space_to_depth`` and
``preprocess_planar_batch``) against the JAX package's, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu.data import dataset as jdataset
from skin_image_analysis_tpu.data import ingest as jingest
from skin_image_analysis_tpu.data import loader as jloader
from skin_image_analysis_tpu.hpo import objective as jobjective
from skin_image_analysis_tpu.ops import pooling as jpool
from skin_image_analysis_tpu.ops import preprocess as jpre
from skin_image_analysis_tpu.ops.pallas import convblock_kernel as jconv
from skin_image_analysis_tpu.ops.pallas import preprocess_kernel as jpk
from skin_image_analysis_tpu.serve import quantize as jquant
from skin_image_analysis_tpu_torch.data import dataset as tdataset
from skin_image_analysis_tpu_torch.data import ingest as tingest
from skin_image_analysis_tpu_torch.data import loader as tloader
from skin_image_analysis_tpu_torch.hpo import objective as tobjective
from skin_image_analysis_tpu_torch.ops import pooling as tpool
from skin_image_analysis_tpu_torch.ops import preprocess as tpre
from skin_image_analysis_tpu_torch.ops.kernels import convblock_kernel as tconv
from skin_image_analysis_tpu_torch.ops.kernels import preprocess_kernel as tpk
from skin_image_analysis_tpu_torch.serve import quantize as tquant
from tests.test_torch_data import write_dicom_cohort, write_metadata
from tests.test_torch_preprocess import _jax_planar_draws


def _tables(root):
    jdf = jingest.read_isic_metadata(root, seed=0)
    tdf = tingest.read_isic_metadata(root, seed=0)
    return (jdataset.LesionTable(jdf, root), tdataset.LesionTable(tdf, root))


@pytest.fixture(scope="module")
def dicom_root(tmp_path_factory):
    """26 native-pixel DICOMs at 8² (no decoder package needed)."""
    root = str(tmp_path_factory.mktemp("names"))
    ids = write_metadata(root, 26, 3)
    write_dicom_cohort(root, 0, 8, 3, ids=ids)
    return root


def test_lesion_table_class_names_match_jax(dicom_root):
    jt, tt = _tables(dicom_root)
    assert tt.get_class_names() == jt.get_class_names() == (
        "benign", "malignant")
    for i in range(2):
        assert tt.get_class(i) == jt.get_class(i)
    custom = tdataset.LesionTable(tt.metadata, dicom_root,
                                  class_names=("malignant", "benign"))
    assert custom.get_class(0) == "malignant"


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("with_row_ids", [False, True])
def test_batch_iterator_super_batches_match_jax(dicom_root, drop_remainder,
                                                with_row_ids):
    """Two epochs of ``[k, B]`` calls from both packages' iterators with
    one seed: the shuffles, labels, row ids and validity (a bad row, the
    padded last batch, the inert padding steps) are equal."""
    jt, tt = _tables(dicom_root)
    jstore = jloader.HostImageStore(jt, 8, workers=1, use_native=False,
                                    layout="planar")
    tstore = tloader.HostImageStore(tt, 8, workers=1, use_native=False)
    jstore.bad_rows = tstore.bad_rows = [3]
    kw = dict(shuffle=True, drop_remainder=drop_remainder, seed=7)
    jit = jloader.BatchIterator(jstore, 4, prefetch=0, **kw)
    tit = tloader.BatchIterator(tstore, 4, device="cpu", prefetch=0, **kw)
    for _ in range(2):
        got = list(tit.super_batches(3, with_row_ids=with_row_ids))
        want = list(jit.super_batches(3, with_row_ids=with_row_ids))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert len(g) == len(w) == (4 if with_row_ids else 3)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_array_dataset_device_pixels_match_jax():
    rng = np.random.default_rng(1)
    pixels = rng.integers(0, 256, (5, 6, 6, 3), dtype=np.uint8)
    labels = np.arange(5) % 2
    tds = tobjective.ArrayDataset(pixels, labels)
    got = tds.device_pixels("cpu")
    want = jobjective.ArrayDataset(pixels, labels).device_pixels()
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tds.device_pixels("cpu") is got  # copied once
    np.testing.assert_array_equal(tds.arena("cpu").permute(0, 2, 3, 1),
                                  got)


def test_dequantize_weights_matches_jax():
    """The int8 round trip of a conv and a Dense kernel (and a bias left
    float32) in both packages' layouts: the same dequantized weights."""
    rng = np.random.default_rng(2)
    conv = rng.standard_normal((3, 3, 4, 8)).astype(np.float32)  # HWIO
    dense = rng.standard_normal((16, 5)).astype(np.float32)      # [in, out]
    bias = rng.standard_normal(5).astype(np.float32)
    want = jquant.dequantize_weights(jquant.quantize_weights_only(
        {"conv": {"kernel": conv}, "dense": {"kernel": dense,
                                             "bias": bias}}))
    got = tquant.dequantize_weights(tquant.quantize_weights_only({
        "conv.weight": torch.from_numpy(conv.transpose(3, 2, 0, 1).copy()),
        "dense.weight": torch.from_numpy(dense.T.copy()),
        "dense.bias": torch.from_numpy(bias)}))
    np.testing.assert_allclose(
        got["conv.weight"].numpy(),
        np.asarray(want["conv"]["kernel"]).transpose(3, 2, 0, 1),
        rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["dense.weight"].numpy(),
                               np.asarray(want["dense"]["kernel"]).T,
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got["dense.bias"].numpy(),
                                  np.asarray(want["dense"]["bias"]))
    assert not np.array_equal(got["dense.weight"].numpy(), dense.T)


def test_space_to_depth_nhwc_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 6, 8, 3)).astype(
        np.float32)
    want = np.asarray(jpool.space_to_depth_nhwc(jnp.asarray(x)))
    got = tpool.space_to_depth_nhwc(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 3, 4, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_convblock_space_to_depth_matches_jax_without_lane_padding():
    """The conv0 kernels' phase split: JAX's planes, bf16, with its
    128-lane padding (all zero) left out."""
    x = np.random.default_rng(4).standard_normal((2, 3, 8, 12)).astype(
        np.float32)
    want = np.asarray(jconv.space_to_depth(jnp.asarray(x)), np.float32)
    got = tconv.space_to_depth(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 12, 4, 6)
    np.testing.assert_array_equal(got.float().numpy(), want[..., :6])
    assert not want[..., 6:].any()


def test_kernels_preprocess_planar_batch_matches_jax():
    """``ops.kernels.preprocess_kernel.preprocess_planar_batch`` (where
    the JAX package keeps it) on JAX's replayed draws."""
    rng = np.random.default_rng(5)
    arena = rng.integers(0, 256, (6, 3, 20, 20), dtype=np.uint8)
    rows = np.array([5, 0, 2, 2], np.int32)
    augment = jpre.AugmentConfig(brightness=0.2, contrast=0.2,
                                 saturation=0.2)
    key = jax.random.key(6)
    want = jpk.preprocess_planar_batch(
        jnp.asarray(arena), key, image_size=16, train=True, augment=augment,
        normalize_imagenet=True, rows=jnp.asarray(rows))
    got = tpk.preprocess_planar_batch(
        torch.from_numpy(arena), image_size=16, train=True,
        augment=tpre.AugmentConfig(*augment), normalize_imagenet=True,
        rows=torch.from_numpy(rows),
        draws=_jax_planar_draws(key, 4, 20, 16, augment))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)

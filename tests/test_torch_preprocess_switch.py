"""``data.pallas_preprocess`` (``make_preprocess_fn(pallas=...)``) of the
port against the JAX package's, on the CPU: which calls take the fused
kernel ("auto": the augmented train path; "on": every planar call; "off":
none), their values (the kernel's plain twin here, JAX's Pallas kernel in
interpret mode), the train loop's choice, and the loop's runs."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu.ops import preprocess as jpre
from skin_image_analysis_tpu.train import loop as jloop
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.ops import preprocess as tpre
from skin_image_analysis_tpu_torch.train import loop as tloop
from skin_image_analysis_tpu_torch.utils import jsonl
from tests.fixtures import make_synthetic_dataset
from tests.test_torch_pooling import one_torch_thread  # noqa: F401
from tests.test_torch_preprocess import _jax_planar_draws

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, T = 4, 16
AUG = jpre.AugmentConfig(brightness=0.2, contrast=0.2, saturation=0.2)


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def _arena(s, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (6, 3, s, s), dtype=np.uint8)


@pytest.mark.parametrize("pallas", ["auto", "on", "off"])
@pytest.mark.parametrize("train,augment", [(True, True), (True, False),
                                           (False, False)])
def test_which_calls_take_the_kernel_follow_jax(monkeypatch, pallas, train,
                                                augment):
    """A fn gathers rows itself (``supports_rows``) exactly where JAX's
    rule puts the kernel, on an accelerator backend ("auto" asks for one;
    the port's "auto" takes the kernel's plain twin on the CPU)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    kw = dict(train=train, layout="planar", pallas=pallas)
    want = jpre.make_preprocess_fn(T, augment=AUG if augment else None, **kw)
    got = tpre.make_preprocess_fn(
        T, augment=tpre.AugmentConfig(*AUG) if augment else None, **kw)
    assert getattr(got, "supports_rows", False) == getattr(
        want, "supports_rows", False)
    with pytest.raises(ValueError, match="auto|on|off"):
        tpre.make_preprocess_fn(T, train=train, pallas="yes")


@pytest.mark.parametrize("pallas", ["on", "off"])
@pytest.mark.parametrize("s", [T, 20])
@pytest.mark.parametrize("train", [True, False])
def test_unaugmented_calls_match_jax(pallas, s, train):
    """Calls without augmentation: with "on" a same-size arena goes
    through the kernel (its centre crop is the frame) and a larger one
    through the reference's resize, as JAX's kernel_crop_ok rule says;
    "off" resizes. float32 out, ImageNet-normalized; 1e-5."""
    arena = _arena(s)
    rows = np.array([5, 0, 2, 2], np.int32)
    jfn = jpre.make_preprocess_fn(T, train=train, layout="planar",
                                  pallas=pallas, normalize_imagenet=True)
    tfn = tpre.make_preprocess_fn(T, train=train, layout="planar",
                                  pallas=pallas, normalize_imagenet=True)
    if getattr(tfn, "supports_rows", False):
        want = jfn(jnp.asarray(arena), None, rows=jnp.asarray(rows))
        got = tfn(torch.from_numpy(arena), None, rows=torch.from_numpy(rows))
    else:
        want = jfn(jnp.asarray(arena[rows]), None)
        got = tfn(torch.from_numpy(arena[rows]), None)
    assert got.shape == (B, T, T, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_on_kernel_launches_for_an_unaugmented_train_call(monkeypatch):
    """With "on" a train call without augmentation on a same-size arena
    goes through the kernel's wrapper; with "off" it does not."""
    calls = []
    real = tpre.fused_preprocess_planar
    monkeypatch.setattr(tpre, "fused_preprocess_planar",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    arena = torch.from_numpy(_arena(T))
    rows = torch.tensor([1, 3], dtype=torch.int32)
    on = tpre.make_preprocess_fn(T, train=True, layout="planar", pallas="on",
                                 out_dtype="bfloat16")
    out = on(arena, None, rows=rows)
    assert calls == [1] and out.dtype == torch.bfloat16
    off = tpre.make_preprocess_fn(T, train=True, layout="planar",
                                  pallas="off")
    np.testing.assert_allclose(off(arena[rows.long()], None).numpy(),
                               out.float().numpy(), atol=4e-3, rtol=0)
    assert calls == [1]


def _jax_batch_draws(key, b, s, t, augment):
    """The draws JAX's preprocess_batch makes from ``key`` (random crop,
    flip, jitter), as the port's AugmentDraws."""
    key, sub = jax.random.split(key)
    ky, kx = jax.random.split(sub)
    ys = jax.random.randint(ky, (b,), 0, s - t + 1)
    xs = jax.random.randint(kx, (b,), 0, s - t + 1)
    key, sub = jax.random.split(key)
    flips = jax.random.bernoulli(sub, 0.5, (b, 1, 1, 1)).reshape(b)
    key, sub = jax.random.split(key)
    kb, kc, ks = jax.random.split(sub, 3)

    def factor(k, half):
        f = jax.random.uniform(k, (b, 1, 1, 1), minval=1 - half,
                               maxval=1 + half)
        return torch.from_numpy(np.array(f).reshape(b))

    return tpre.AugmentDraws(
        torch.from_numpy(np.stack([np.asarray(ys), np.asarray(xs)], 1)
                         .astype(np.int32)),
        torch.from_numpy(np.asarray(flips).astype(np.int32)),
        factor(kb, augment.brightness), factor(kc, augment.contrast),
        factor(ks, augment.saturation))


@pytest.mark.parametrize("pallas", ["on", "off"])
def test_augmented_train_calls_match_jax(pallas):
    """The augmented train path, 20 -> 16 with every jitter: "on" through
    the kernel on JAX's kernel draws, "off" through the plain path on
    JAX's preprocess_batch draws; 1e-5."""
    arena = _arena(20, seed=4)
    rows = np.array([3, 3, 0, 5], np.int32)
    key = jax.random.key(8)
    jfn = jpre.make_preprocess_fn(T, train=True, augment=AUG,
                                  layout="planar", pallas=pallas,
                                  normalize_imagenet=True)
    tfn = tpre.make_preprocess_fn(T, train=True,
                                  augment=tpre.AugmentConfig(*AUG),
                                  layout="planar", pallas=pallas,
                                  normalize_imagenet=True)
    if pallas == "on":
        want = jfn(jnp.asarray(arena), key, rows=jnp.asarray(rows))
        got = tfn(torch.from_numpy(arena), rows=torch.from_numpy(rows),
                  draws=_jax_planar_draws(key, B, 20, T, AUG))
    else:
        assert not hasattr(tfn, "supports_rows")
        want = jfn(jnp.asarray(arena[rows]), key)
        got = tfn(torch.from_numpy(arena[rows]),
                  draws=_jax_batch_draws(key, B, 20, T, AUG))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def _train_cfg(root, results, pallas, augment, cls=tconfig):
    return cls.TrainConfig(
        epochs=2, seed=0, results_dir=results, eval_every=1,
        data=cls.DataConfig(root_dir=root, image_size=16, canonical_size=16,
                            batch_size=8, augment=augment,
                            steps_per_dispatch=2, decode_workers=1,
                            pallas_preprocess=pallas),
        model=cls.ModelConfig(conv_features=(4,), linear_features=(16,),
                              dropout=(0.0,), image_size=16,
                              compute_dtype="float32"),
        optim=cls.OptimConfig(optimizer="sgd", learning_rate=1e-2))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("switch"))
    make_synthetic_dataset(root, n=36, seed=4, image_size=20)
    return root


class _Chosen(Exception):
    pass


@pytest.mark.parametrize("pallas", ["on", "off"])
@pytest.mark.parametrize("augment", [True, False])
def test_run_training_chooses_the_train_path_as_jax(monkeypatch, tmp_path,
                                                    cohort, pallas, augment):
    """JAX's ``run_training`` makes its train preprocess with planar
    arenas and the kernel for "on", the plain path for "off" (hwc arenas
    there; the port's stay planar): the port's loop makes the same
    choice."""
    seen = {}
    real = jloop.make_preprocess_fn

    def record(*args, **kw):
        fn = real(*args, **kw)
        if kw.get("train"):
            seen.update(kw, kernel=getattr(fn, "supports_rows", False))
            raise _Chosen
        return fn

    monkeypatch.setattr(jloop, "make_preprocess_fn", record)
    with pytest.raises(_Chosen):
        jloop.run_training(_train_cfg(cohort, str(tmp_path), pallas, augment,
                                      jconfig), verbose=False)
    assert seen["layout"] == ("planar" if pallas == "on" else "hwc")
    cfg = _train_cfg(cohort, str(tmp_path), pallas, augment)
    train_pre, eval_pre = tloop._preprocess_fns(
        cfg, cfg.model, tloop._default_augment(cfg))
    assert getattr(train_pre, "supports_rows", False) == seen["kernel"] \
        == (pallas == "on")
    assert not hasattr(eval_pre, "supports_rows")


def test_run_training_on_and_off_train_alike(monkeypatch, tmp_path, cohort):
    """Without augmentation on a 16² arena cropped to 16², "on" trains
    through the kernel (its wrapper called once a step) and "off" through
    the plain path, to the same losses and records (1e-6);
    ``train_config.json`` keeps the setting."""
    calls = []
    real = tpre.fused_preprocess_planar
    monkeypatch.setattr(tpre, "fused_preprocess_planar",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    runs = {}
    for pallas in ("on", "off"):
        before = len(calls)
        folder = tloop.run_training(
            _train_cfg(cohort, str(tmp_path / pallas), pallas, False),
            verbose=False, device="cpu")
        runs[pallas] = (folder, len(calls) - before)
        with open(os.path.join(folder, "train_config.json")) as f:
            back = tconfig.train_config_from_dict(json.load(f))
        assert back.data.pallas_preprocess == pallas
    assert runs["off"][1] == 0 and runs["on"][1] > 0

    def records(folder):
        return [r for n in sorted(os.listdir(folder)) if n[0].isdigit()
                for r in jsonl.read_records(os.path.join(folder, n))]

    got, want = records(runs["on"][0]), records(runs["off"][0])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["correct"] == w["correct"]
        assert g["avg_batch_loss"] == pytest.approx(w["avg_batch_loss"],
                                                    abs=1e-6)

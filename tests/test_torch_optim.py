"""The port's adamw, rmsprop and sgd against optax and the JAX package, on
the CPU: single and repeated updates, the narrow-``nu_dtype`` refusal, a
whole ``run_training`` of each package under each optimizer from the
same JAX-written artifact (per-step losses to rtol 1e-4), and the
snapshot of each optimizer's state restored bit for bit."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu.train import checkpoint as jckpt
from skin_image_analysis_tpu.train import loop as jloop
from skin_image_analysis_tpu.train import state as jstate
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from skin_image_analysis_tpu_torch.train import loop as tloop
from skin_image_analysis_tpu_torch.train import state as tstate
from skin_image_analysis_tpu_torch.train import step as tstep
from tests.fixtures import make_synthetic_dataset
from tests.test_torch_cli import TIMES, _jax_one_device, _records
from tests.test_torch_train import SHAPES, SMALL_MODEL, _check_record
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTIMIZERS = {
    "adamw": dict(optimizer="adamw", weight_decay=1e-2),
    "adamw_bf16": dict(optimizer="adamw", weight_decay=1e-2,
                       moment_dtype="bfloat16"),
    "adamw_cosine": dict(optimizer="adamw", weight_decay=1e-2,
                         lr_schedule="cosine", lr_decay_steps=4),
    "rmsprop": dict(optimizer="rmsprop"),
    "sgd": dict(optimizer="sgd"),
    "sgd_momentum": dict(optimizer="sgd", momentum=0.9),
}


def _within_one_bf16_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    """As ``test_adam_matches_optax`` holds adam's bf16 moments."""
    _, e = np.frexp(want.astype(np.float32))
    return bool((np.abs(got - want.astype(np.float32))
                 <= np.exp2(e - 8.0)).all())


@pytest.mark.parametrize("updates", [1, 5])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name, updates):
    """Params after 1 and 5 updates on fixed gradients: float32 to rtol
    1e-6; the state (adamw's mu and nu, rmsprop's nu, sgd's trace) too,
    a bf16 mu within one bf16 ulp."""
    cfg = dict(learning_rate=3e-2, **OPTIMIZERS[name])
    rng = np.random.default_rng(updates)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(size=s).astype(np.float32) for s in SHAPES]
             for _ in range(updates)]
    tx = jstate.make_optimizer(jconfig.OptimConfig(**cfg))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = tstate.make_optimizer(tconfig.OptimConfig(**cfg), tp)
    assert opt.name == cfg["optimizer"]
    for g in grads:
        upd, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state,
                                   jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(x) for x in g])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert opt.count == updates
    theirs = {}
    for part in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(
            x, "_fields")):
        for field in ("mu", "nu", "trace"):
            if hasattr(part, field):
                theirs[field] = getattr(part, field)
    mine = opt.state()
    assert set(mine) == set(theirs)
    for field, tensors in mine.items():
        for a, b in zip(tensors, theirs[field]):
            b = np.asarray(b)
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            if b.dtype == np.float32:
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                           atol=1e-7)
            else:
                assert _within_one_bf16_ulp(a.float().numpy(), b)


@pytest.mark.parametrize("name", ["adamw", "rmsprop", "sgd"])
def test_narrow_nu_dtype_is_adam_only(name):
    cfg = dict(optimizer=name, nu_dtype="bfloat16")
    with pytest.raises(ValueError, match="only supported with"):
        jstate.make_optimizer(jconfig.OptimConfig(**cfg))
    with pytest.raises(ValueError, match="only supported with"):
        tstate.make_optimizer(tconfig.OptimConfig(**cfg),
                              [torch.zeros(2)])


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstate.make_optimizer(tconfig.OptimConfig(optimizer="lamb"),
                              [torch.zeros(2)])


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort32"))
    make_synthetic_dataset(root, n=72, seed=11, image_size=32)
    return root


def paired_runs(tmp, cohort, epochs=2, data=None, optim=None, run=None,
                **train_kw):
    """One run of each package on ``cohort`` from the same JAX-written
    artifact (``SMALL_MODEL``, dropout 0, no augment, the imbalanced
    split unless ``data`` says otherwise), recording the
    per-step losses of both the k-step calls and the one-batch steps.
    ``run(package_loop, cfg)`` runs a config (default ``run_training``);
    returns the two folders and the two lists of per-step losses."""
    jcfg_model = jconfig.ModelConfig(**SMALL_MODEL)
    state, _ = jstate.create_train_state(jcfg_model, jconfig.OptimConfig(),
                                         jax.random.key(0))
    artifact = str(tmp / "init.msgpack")
    jckpt.save_model(artifact, jcfg_model, state.params)
    jcfg = jconfig.TrainConfig(
        epochs=epochs, results_dir=str(tmp / "jax"), init_from=artifact,
        log_every_batches=0, seed=0,
        data=jconfig.DataConfig(
            root_dir=cohort, image_size=32, canonical_size=32,
            batch_size=4, decode_workers=2, prefetch_depth=1, seed=0,
            **{"steps_per_dispatch": 2, "balance": False, **(data or {})}),
        optim=jconfig.OptimConfig(**{"learning_rate": 3e-3,
                                     **(optim or {})}),
        **train_kw)
    tcfg = tconfig.train_config_from_dict(json.loads(jconfig.to_json(jcfg)))
    tcfg = dataclasses.replace(tcfg, results_dir=str(tmp / "port"))
    if run is None:
        def run(loop, cfg):
            kw = {"device": "cpu"} if loop is tloop else {}
            return loop.run_training(cfg, verbose=False, **kw)

    jax_losses, port_losses = [], []
    with _jax_one_device() as mp:
        def recording(make):
            def made(*a, **kw):
                step = make(*a, **kw)

                def call(*args):
                    state, m = step(*args)
                    m = jax.device_get(m)
                    if np.any(m["count"]):  # not an inert warm-up call
                        jax_losses.append(np.asarray(m["loss"]).reshape(-1))
                    return state, m
                return call
            return made

        mp.setattr(jloop, "make_multi_train_step",
                   recording(jloop.make_multi_train_step))
        mp.setattr(jloop, "make_train_step",
                   recording(jloop.make_train_step))
        jax_folder = run(jloop, jcfg)

        def port_recording(step):
            def call(*a, **kw):
                m = step(*a, **kw)
                port_losses.append(m["loss"].detach().numpy().reshape(-1))
                return m
            return call

        mp.setattr(tloop, "multi_train_step",
                   port_recording(tloop.multi_train_step))
        mp.setattr(tloop, "train_step", port_recording(tloop.train_step))
        port_folder = run(tloop, tcfg)
    return dict(jax=jax_folder, port=port_folder, cfg=tcfg,
                jax_losses=np.concatenate(jax_losses),
                port_losses=np.concatenate(port_losses))


def check_paired(runs):
    """Per-step losses to rtol 1e-4; equal records (counts, accuracy and
    DI exact, AUCs to 1e-6, the average loss to rtol 1e-4) and
    progress."""
    np.testing.assert_allclose(runs["port_losses"], runs["jax_losses"],
                               rtol=1e-4, atol=0)
    assert tloop.completed_epochs(runs["port"]) \
        == jloop.completed_epochs(runs["jax"])
    mine, theirs = _records(runs["port"]), _records(runs["jax"])
    assert len(mine) == len(theirs) > 0
    for got, want in zip(mine, theirs):
        assert set(got) == set(want) == set(tloop.RECORD_KEYS)
        _check_record(
            {k: v for k, v in got.items() if k not in TIMES},
            {k: v for k, v in want.items()
             if k not in TIMES and k != "avg_batch_loss"},
            lambda k: 1e-6 if k.startswith("auc") else 0.0)
        assert got["avg_batch_loss"] == pytest.approx(
            want["avg_batch_loss"], rel=1e-4)


@pytest.mark.parametrize("name", ["adamw", "rmsprop", "sgd_momentum"])
def test_whole_run_matches_jax(cohort, tmp_path, name):
    """A whole run of each package under the optimizer: the same per-step
    losses and records."""
    runs = paired_runs(tmp_path, cohort, optim=OPTIMIZERS[name])
    assert len(runs["port_losses"]) >= 10
    check_paired(runs)
    cfg = json.load(open(os.path.join(runs["port"], "train_config.json")))
    assert cfg["optim"]["optimizer"] == OPTIMIZERS[name]["optimizer"]


def _trained(optim: dict, seed: int, steps: int):
    state = tstate.create_train_state(
        tconfig.ModelConfig(**SMALL_MODEL), tconfig.OptimConfig(**optim),
        seed, "cpu")
    rng = np.random.default_rng(seed)
    arena = torch.from_numpy(rng.integers(0, 256, (8, 3, 32, 32),
                                          dtype=np.uint8))
    pre = tloop.make_preprocess_fn(32, train=False, layout="planar")
    idx = rng.integers(0, 8, (steps, 4)).astype(np.int32)
    tstep.multi_train_step(state, arena, idx, idx % 2,
                           np.ones_like(idx, bool), None, pre)
    return state, arena, pre


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_snapshot_restores_each_optimizer_bit_for_bit(tmp_path, name):
    """The optimizer's name, count and state restored exactly into a fresh
    state, which then trains on as the original does."""
    optim = dict(OPTIMIZERS[name], learning_rate=1e-3)
    state, arena, pre = _trained(optim, 0, 3)
    tckpt.save_train_state(str(tmp_path), state)
    fresh, _, _ = _trained(optim, 1, 1)
    tckpt.restore_train_state(str(tmp_path), fresh)
    a, b = tckpt.snapshot(state), tckpt.snapshot(fresh)
    assert a["optimizer"] == b["optimizer"] == optim["optimizer"]
    assert a["opt_count"] == b["opt_count"] == 3
    assert set(a["opt_state"]) == set(b["opt_state"])
    for key in a["opt_state"]:
        for x, y in zip(a["opt_state"][key], b["opt_state"][key]):
            assert x.dtype == y.dtype and torch.equal(x, y)
    idx = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    losses = [tstep.multi_train_step(s, arena, idx, idx % 2,
                                     np.ones_like(idx, bool), None,
                                     pre)["loss"] for s in (state, fresh)]
    assert torch.equal(*losses)
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("saved,into", [
    ("adamw", "rmsprop"), ("sgd", "adamw"), ("sgd_momentum", "sgd"),
])
def test_restore_into_another_optimizer_is_refused(tmp_path, saved, into):
    state, _, _ = _trained(dict(OPTIMIZERS[saved], learning_rate=1e-3), 0,
                           1)
    tckpt.save_train_state(str(tmp_path), state)
    other, _, _ = _trained(dict(OPTIMIZERS[into], learning_rate=1e-3), 1, 1)
    with pytest.raises(ValueError) as err:
        tckpt.restore_train_state(str(tmp_path), other)
    if OPTIMIZERS[saved]["optimizer"] != OPTIMIZERS[into]["optimizer"]:
        assert OPTIMIZERS[saved]["optimizer"] in str(err.value)
        assert OPTIMIZERS[into]["optimizer"] in str(err.value)
    else:  # sgd with momentum keeps a trace, sgd without none
        assert "trace" in str(err.value)

"""The port's HPO (``hpo/``, ``cli/tone_bias_optuna.py``, the train CLI's
``--from-hpo``) against the JAX package's, on the CPU: the same
suggestions from the search space, the ask/tell engine, TPE and the
median pruner on the same seeds; the same replayed artifacts; the padded
super-network's geometry against ``jax.eval_shape``; one stacked wave of 3
trials against three lone JAX runs of the same trials from the same
weights; the traced per-trial dropout rates against JAX's
``rate_override``; the objective's sample split and batches; the
rolling-wave driver; the optuna CLI and ``--from-hpo`` end to end; and a
subprocess that runs the new paths (HPO, replay, int8 quantization) with
jax, flax, optax and the JAX package unimportable.

Tolerances: suggestions, replayed configs and trial states exactly equal;
the stacked wave's parameters within 1e-6 of the lone JAX runs after two
Adam steps (float32; the port's input is the preprocess kernel's plain
twin, ``x * (1/255)``, JAX's ``x / 255``, a 1-ulp difference); a lone
port run equal to its stacked lane within 1e-6; the dropped forward's
log-probs within 1e-4 of JAX's and its gradients within 1e-4 + 1e-3
relative (float32, as ``test_torch_model.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu.hpo import objective as jobjective
from skin_image_analysis_tpu.hpo import population as jpop
from skin_image_analysis_tpu.hpo import replay as jreplay
from skin_image_analysis_tpu.hpo import space as jspace
from skin_image_analysis_tpu.hpo import study as jstudy
from skin_image_analysis_tpu.hpo import tpe as jtpe
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch.cli import tone_bias_optuna
from skin_image_analysis_tpu_torch.cli import tone_bias_train as ttrain_cli
from skin_image_analysis_tpu_torch.config import HpoConfig, MeshConfig
from skin_image_analysis_tpu_torch.hpo import objective as tobjective
from skin_image_analysis_tpu_torch.hpo import parallel as tparallel
from skin_image_analysis_tpu_torch.hpo import population as tpop
from skin_image_analysis_tpu_torch.hpo import replay as treplay
from skin_image_analysis_tpu_torch.hpo import space as tspace
from skin_image_analysis_tpu_torch.hpo import study as tstudy
from skin_image_analysis_tpu_torch.hpo import tpe as ttpe
from skin_image_analysis_tpu_torch.hpo import wave as twave
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.parallel import create_mesh
from tests.test_torch_pooling import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BLOCKED = ("jax", "jaxlib", "flax", "optax", "skin_image_analysis_tpu")
#: the artifact keys of the JAX CLI (cli/tone_bias_optuna.py)
ARTIFACT_KEYS = {"best_value", "best_params", "trials", "epochs", "device",
                 "batch_size", "sample_size", "image_size", "elapsed_s",
                 "n_pruned", "n_complete"}
WAVE_KEYS = {"waves", "refills", "lane_epochs", "live_lane_epochs"}
REFERENCE_ARTIFACT = (
    "{'n_units_l0': 24, 'n_conv_layers': 2, 'n_units_conv_l0': 20, "
    "'n_units_conv_l1': 16, 'n_linear_layers': 2, 'n_units_linear_l0': 32, "
    "'n_units_linear_l1': 18, 'dropout_l0': 0.3, 'dropout_l1': 0.25, "
    "'optimizer': 'Adam', 'lr': 0.001, 'TRIALS': 100, 'EPOCHS': 10, "
    "'DEVICE': mps, 'BATCHSIZE': 32, 'SAMPLE_SIZE': 300,}")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg_fields(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items()}


# -- space / study / tpe / replay ------------------------------------------


def _run_study(pkg_study, pkg_space, sampler, n: int):
    """n trials of the ISIC space with three reports each; the value is a
    fixed function of the suggestions, so both packages see the same."""
    study = pkg_study.create_study(
        "maximize", sampler=sampler,
        pruner=pkg_study.MedianPruner(n_startup_trials=3))

    def objective(trial):
        model_cfg, optim_cfg = pkg_space.define_isic_model(
            trial, image_size=64)
        base = (sum(model_cfg.conv_features) % 97) / 97.0
        for step in range(3):
            trial.report(base + 0.01 * step + np.log10(
                optim_cfg.learning_rate) / 100.0, step)
            if trial.should_prune():
                raise pkg_study.TrialPruned()
        return base + 0.05

    study.optimize(objective, n_trials=n)
    return study


@pytest.mark.parametrize("sampler", ["tpe", "random"])
def test_space_study_and_samplers_match_jax(sampler):
    """The same seeds give the same suggestions, reports, prunes, states
    and best trial (TPE past its 10 startup trials)."""
    if sampler == "tpe":
        js, ts = jtpe.TPESampler(seed=5), ttpe.TPESampler(seed=5)
    else:
        js, ts = jstudy.RandomSampler(5), tstudy.RandomSampler(5)
    want = _run_study(jstudy, jspace, js, 16)
    got = _run_study(tstudy, tspace, ts, 16)
    assert [t.params for t in got.trials] == [t.params for t in want.trials]
    assert [(t.state, t.value, t.intermediate_values) for t in got.trials] \
        == [(t.state, t.value, t.intermediate_values) for t in want.trials]
    assert got.best_params == want.best_params
    assert len(got.pruned_trials) == len(want.pruned_trials) > 0


def test_best_model_and_replay_match_jax(tmp_path):
    assert tspace.best_hyperparameters() == jspace.best_hyperparameters()
    for args in ((224, "bfloat16"), (64, "float32")):
        tm, to = tspace.create_best_model_config(*args)
        jm, jo = jspace.create_best_model_config(*args)
        assert _cfg_fields(tm).items() >= {
            k: v for k, v in _cfg_fields(jm).items()
            if k in _cfg_fields(tm)}.items()
        assert (to.optimizer, to.learning_rate) == (jo.optimizer,
                                                    jo.learning_rate)
    ref = tmp_path / "optuna_ref.json"
    ref.write_text(REFERENCE_ARTIFACT)
    paths = [str(ref)] + sorted(
        os.path.join(ROOT, f) for f in os.listdir(ROOT)
        if f.startswith("optuna_") and f.endswith(".json"))
    for path in paths:
        raw = treplay.parse_reference_artifact(path)
        assert raw == jreplay.parse_reference_artifact(path)
        assert treplay.reference_params_to_ours(raw) == \
            jreplay.reference_params_to_ours(raw)
        for size in (224, 32):
            tm, to = treplay.replay_artifact(path, image_size=size)
            jm, jo = jreplay.replay_artifact(path, image_size=size)
            assert (tm.conv_features, tm.linear_features, tm.dropout,
                    tm.image_size, tm.compute_dtype) == (
                jm.conv_features, jm.linear_features, jm.dropout,
                jm.image_size, jm.compute_dtype)
            assert (to.optimizer, to.learning_rate) == (jo.optimizer,
                                                        jo.learning_rate)
    with pytest.raises(KeyError, match="replay missing"):
        tstudy.TrialReplay({}).suggest_int("n_conv_layers", 1, 3)


# -- the padded super-network ----------------------------------------------


SKEL = dict(n_conv=1, n_linear=2, optimizer="adam", image_size=16,
            compute_dtype="float32", pad_width=8)
CONV_W = np.array([[4, 6], [8, 3], [5, 8]])
LIN_W = np.array([[6, 3], [8, 8], [2, 5]])
LRS = np.array([1e-2, 3e-3, 1e-3], np.float32)
K, B, MB = 3, 8, 4


def test_padded_geometry_matches_jax_eval_shape():
    """The padded model's parameters against ``jax.eval_shape`` of the JAX
    package's padded init, at the protocol's full width (no init runs),
    and the footprint and population caps."""
    for kw in (dict(n_conv=3, n_linear=3, optimizer="adam"),
               dict(n_conv=6, n_linear=5, optimizer="sgd", image_size=128),
               SKEL):
        jsk, tsk = jpop.WaveSkeleton(**kw), tpop.WaveSkeleton(**kw)
        shapes = jax.eval_shape(
            lambda k: jpop.init_trial_params(
                jsk, k, jnp.full((jsk.conv_count,), 16),
                jnp.full((jsk.n_linear,), 16)), jax.random.key(0))
        model = build_model(tsk.padded_model_config(), device="meta")
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        want = {}
        for i in range(jsk.conv_count):
            kern = shapes[f"ConvBlock_{i}"]["Conv_0"]["kernel"].shape
            want[f"conv_blocks.{i}.weight"] = (kern[3], kern[2], kern[0],
                                               kern[1])
            want[f"conv_blocks.{i}.bias"] = (kern[3],)
        for j in range(jsk.n_linear):
            kern = shapes[f"MlpBlock_{j}"]["Dense_0"]["kernel"].shape
            want[f"mlp_blocks.{j}.weight"] = kern[::-1]
            want[f"mlp_blocks.{j}.bias"] = (kern[1],)
        kern = shapes["Dense_0"]["kernel"].shape
        want["head.weight"], want["head.bias"] = kern[::-1], (kern[1],)
        assert got == want
        assert tsk.padded_param_bytes() == jsk.padded_param_bytes()
        for b in (8, 32, 256):
            assert tpop.max_population(tsk, b) == jpop.max_population(jsk, b)
            assert tpop.default_microbatch(tsk, b) == \
                jpop.default_microbatch(jsk, b)


@pytest.fixture(scope="module")
def wave_data():
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (24, 16, 16, 3), np.uint8)
    lb = rng.integers(0, 2, 24)
    steps = [rng.integers(0, 24, (K, B)) for _ in range(2)]
    return px, lb, steps


@pytest.fixture(scope="module")
def jax_wave(wave_data):
    """The port's seeded init of the three trials (stacked state_dicts),
    and each trial run ALONE (K=1) for two steps by the JAX package's
    per-trial step from the same weights, on its rows, dropout rate 0."""
    px, lb, steps = wave_data
    tsk = tpop.WaveSkeleton(**SKEL)
    progs = tpop.WavePrograms(tsk, MB, B // MB, "cpu")
    params, _ = progs.init_wave([7, 8, 9], torch.as_tensor(CONV_W),
                                torch.as_tensor(LIN_W))
    jsk = jpop.WaveSkeleton(**SKEL)
    vstep = jax.jit(jpop._trial_kernels(jsk, K, MB, B // MB)[0])
    tx = jpop._scale_tx(SKEL["optimizer"])
    lone = []
    for k in range(K):
        p = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(
            {n: v[k] for n, v in params.items()}, SKEL["image_size"]))
        o = jax.tree.map(lambda a: a[None], tx.init(p))
        p = jax.tree.map(lambda a: a[None], p)
        for rows in steps:
            p, o = vstep(
                p, o, jnp.asarray(CONV_W[k:k + 1]),
                jnp.asarray(LIN_W[k:k + 1]), jnp.zeros((1, 2)),
                jnp.asarray(LRS[k:k + 1]), jnp.asarray(px[rows[k]][None]),
                jnp.asarray(lb[rows[k]][None].astype(np.int32)),
                jax.random.split(jax.random.key(5), 1))
        lone.append(jax.tree.map(lambda a: np.asarray(a[0]), p))
    return params, lone


def test_wave_matches_lone_jax_runs(wave_data, jax_wave):
    """One stacked wave of 3 trials (``WavePrograms.train_step``, vmap
    over the lanes) against each trial run alone by the JAX package from
    the same weights: the parameters after two Adam steps, and the
    stacked validation accuracy against each JAX-trained trial's."""
    px, lb, steps = wave_data
    params, lone = jax_wave
    tsk = tpop.WaveSkeleton(**SKEL)
    progs = tpop.WavePrograms(tsk, MB, B // MB, "cpu")
    masks = tpop.wave_masks(tsk, torch.as_tensor(CONV_W),
                            torch.as_tensor(LIN_W))
    opt = tpop.init_opt_state("adam", params)
    pool, pool_lb = tpop.planar_pool(px, "cpu"), torch.as_tensor(lb)
    gen = torch.Generator().manual_seed(0)
    for rows in steps:
        params, opt, loss = progs.train_step(
            params, opt, pool, pool_lb, torch.as_tensor(rows), masks,
            torch.zeros((K, 2)), torch.as_tensor(LRS),
            progs.draw_noise(K, gen))
        assert loss.shape == (K,) and torch.isfinite(loss).all()
    want = [bridge.flax_to_state_dict(t, SKEL["image_size"]) for t in lone]
    for k in range(K):
        for name, w in want[k].items():
            torch.testing.assert_close(params[name][k], w, atol=1e-6,
                                       rtol=0)
    # the padded channels stay exactly zero (trial 1's block 1 is 3 wide)
    assert float(params["conv_blocks.1.weight"][1, 3:].abs().max()) == 0.0
    vb = torch.as_tensor(np.arange(24).reshape(1, 3, 8)).expand(K, -1, -1)
    acc = progs.valid_accuracy(params, pool, pool_lb, vb)
    jax_trained = {n: torch.stack([w[n] for w in want]) for n in want[0]}
    assert torch.equal(acc, progs.valid_accuracy(jax_trained, pool,
                                                 pool_lb, vb))


def test_stacked_lane_equals_lone_port_run(wave_data):
    """With dropout on: lane k of the stacked step equals a K=1 run of
    trial k given lane k's state, rows and dropout draws."""
    px, lb, steps = wave_data
    tsk = tpop.WaveSkeleton(**SKEL)
    progs = tpop.WavePrograms(tsk, MB, B // MB, "cpu")
    cw, lw = torch.as_tensor(CONV_W), torch.as_tensor(LIN_W)
    masks = tpop.wave_masks(tsk, cw, lw)
    drops = torch.tensor([[0.3, 0.2], [0.5, 0.25], [0.4, 0.45]])
    params, opt = progs.init_wave([11, 12, 13], cw, lw)
    pool, pool_lb = tpop.planar_pool(px, "cpu"), torch.as_tensor(lb)
    gen = torch.Generator().manual_seed(3)
    draws = [progs.draw_noise(K, gen) for _ in steps]
    p, o = params, opt
    stacked = []
    for rows, noise in zip(steps, draws):
        p, o, loss = progs.train_step(p, o, pool, pool_lb,
                                      torch.as_tensor(rows), masks, drops,
                                      torch.as_tensor(LRS), noise)
        stacked.append(loss)
    for k in (0, 2):
        sl = slice(k, k + 1)
        pk = {n: v[sl] for n, v in params.items()}
        ok = {n: ({m: w[sl] for m, w in v.items()}
                  if isinstance(v, dict) else v[sl])
              for n, v in opt.items()}
        for i, (rows, noise) in enumerate(zip(steps, draws)):
            pk, ok, loss = progs.train_step(
                pk, ok, pool, pool_lb, torch.as_tensor(rows[sl]),
                {n: v[sl] for n, v in masks.items()}, drops[sl],
                torch.as_tensor(LRS[sl]), [[u[sl] for u in mb]
                                           for mb in noise])
            torch.testing.assert_close(loss[0], stacked[i][k], atol=1e-6,
                                       rtol=0)
        for n in pk:
            torch.testing.assert_close(pk[n][0], p[n][k], atol=1e-6,
                                       rtol=0)


DROP_CFG = dict(conv_features=(4, 6), linear_features=(6, 5),
                dropout=(0.0, 0.0), image_size=16, compute_dtype="float32")


@pytest.mark.parametrize("rates", [(0.3, 0.2), (0.5, 0.25), (0.4, 0.45)])
def test_traced_dropout_rates_match_jax(rates, monkeypatch):
    """The per-trial dropout the stacked step trains through
    (``dropout_rates``/``dropout_noise``) against the JAX package's
    ``MlpBlock.rate_override``: one train-mode forward and gradient from
    the same weights, with JAX's Bernoulli draws replaced by
    ``noise < keep`` on the port's own uniform draws. float32: log-probs
    within 1e-4, gradients within 1e-4 + 1e-3 relative (the tolerances of
    ``test_torch_model.py``)."""
    from skin_image_analysis_tpu.config import ModelConfig as JModelConfig
    from skin_image_analysis_tpu.models import cnn as jcnn
    from skin_image_analysis_tpu.ops.losses import nll_loss as jnll
    from skin_image_analysis_tpu_torch.config import ModelConfig
    from skin_image_analysis_tpu_torch.ops.losses import nll_loss as tnll

    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 1, 1, 0], np.int32)
    noise = [rng.uniform(0, 1, (4, w)).astype(np.float32)
             for w in DROP_CFG["linear_features"]]
    tmodel = build_model(ModelConfig(**DROP_CFG), device="cpu",
                         generator=torch.Generator().manual_seed(3))
    params = jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(
        tmodel.state_dict(), 16))
    jmodel = jcnn.build_model(JModelConfig(**DROP_CFG))

    drawn = []

    def bernoulli(key, p, shape):
        j = len(drawn) % len(noise)
        drawn.append(j)
        assert tuple(shape) == noise[j].shape
        return jnp.asarray(noise[j]) < p

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    def jloss(p):
        lp = jmodel.apply({"params": p}, jnp.asarray(x), train=True,
                          dropout_rates=jnp.asarray(rates, jnp.float32),
                          rngs={"dropout": jax.random.key(0)})
        return jnll(lp, jnp.asarray(labels)), lp

    (_, lp_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    assert drawn == [0, 1]
    lp_t = tmodel(torch.from_numpy(x), train=True,
                  dropout_rates=torch.tensor(rates),
                  dropout_noise=[torch.from_numpy(u) for u in noise])
    tnll(lp_t, torch.from_numpy(labels)).backward()
    # the draws drop units, and the dropped forward is not the eval one
    assert all((u >= 1 - r).any() for u, r in zip(noise, rates))
    assert not torch.allclose(lp_t, tmodel(torch.from_numpy(x)))
    np.testing.assert_allclose(lp_t.detach().numpy(), np.asarray(lp_j),
                               atol=1e-4)
    g_t = bridge.flax_to_state_dict(jax.tree.map(np.asarray, g_j), 16)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_t[name].numpy(),
                                   atol=1e-4, rtol=1e-3, err_msg=name)


def test_train_wave_lockstep(wave_data):
    """The lockstep driver: K lanes over the wave's shared sample, each in
    its own batch order; the histories' shapes, finite losses, padded
    channels left at zero, and an epoch callback that stops the wave."""
    px, lb, _ = wave_data
    tsk = tpop.WaveSkeleton(**SKEL)
    seen = []
    out = tpop.train_wave(
        tsk, CONV_W, LIN_W, np.full((K, 2), 0.3), LRS, px[:16], lb[:16],
        px[16:], lb[16:], epochs=3, batch_size=B, seed=1,
        microbatch=MB, device="cpu",
        epoch_callback=lambda e, acc: seen.append(e) or e < 1)
    assert seen == [0, 1]
    assert out["accuracy_history"].shape == (2, K)
    assert out["losses"].shape == (2 * (16 // B), K)
    assert np.isfinite(out["losses"]).all()
    assert float(out["params"]["mlp_blocks.1.weight"][2, 5:].abs().max()) \
        == 0.0


def test_optimizer_cores_match_optax():
    """adam, rmsprop and sgd updates per lane against optax's lr-free
    transforms over three steps."""
    rng = np.random.default_rng(2)
    grads = [rng.normal(size=(2, 5)).astype(np.float32) for _ in range(3)]
    for name in ("adam", "rmsprop", "sgd"):
        tx = jpop._scale_tx(name)
        jstate = tx.init(jnp.zeros(5))
        tstate = tpop.init_opt_state(name, {"w": torch.zeros(2, 5)})
        for g in grads:
            want, jstate = tx.update(jnp.asarray(g[0]), jstate)
            got, tstate = tpop.scale_updates(name, {"w": torch.tensor(g)},
                                             tstate)
            np.testing.assert_allclose(got["w"][0].numpy(),
                                       np.asarray(want), rtol=1e-6,
                                       atol=1e-7)


# -- the objective, the wave driver, the population -------------------------


def test_objective_split_batches_and_input(wave_data):
    px, lb, _ = wave_data
    jt, jv = jobjective.ArrayDataset.sample_split(px, lb, 18, seed=4)
    tt, tv = tobjective.ArrayDataset.sample_split(px, lb, 18, seed=4)
    np.testing.assert_array_equal(tt.pixels, jt.pixels)
    np.testing.assert_array_equal(tv.labels, jv.labels)
    want = [np.asarray(b["row_id"]) for b in jobjective._batches(
        jt, 4, 8, np.random.default_rng(1))]
    got = list(tobjective._batches(tt, 4, 8, np.random.default_rng(1)))
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    arena = tt.arena("cpu")
    rows = torch.tensor([3, 0, 5])
    x = tobjective.raw_input(arena, rows=rows)
    torch.testing.assert_close(
        x, torch.from_numpy(tt.pixels[[3, 0, 5]]).float(), atol=0, rtol=0)


def test_run_wave_study_and_population():
    """The rolling-lane driver at a small size: every trial finished and
    told, the skeleton shared within a wave, refills counted; and the
    stacked lr population of one architecture."""
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 2, 64)
    px = (np.clip(rng.normal(0, 0.05, (64, 16, 16, 3))
                  + labels[:, None, None, None] * 0.6 + 0.2, 0, 1)
          * 255).astype(np.uint8)
    cfg = HpoConfig(trials=5, epochs=2, batch_size=8, sample_size=48,
                    n_train_examples=16, n_valid_examples=8, seed=2)
    study, stats = twave.run_wave_study(
        px, labels, cfg, study=tstudy.create_study(
            "maximize", sampler=tstudy.RandomSampler(2)),
        wave_size=2, width_range=(4, 8), verbose=False, device="cpu")
    assert stats["trials"] == len(study.trials) == 5
    assert {t.state for t in study.trials} <= {"COMPLETE", "PRUNED"}
    assert all(t.value is not None for t in study.trials)
    assert stats["lane_epochs"] >= stats["live_lane_epochs"] > 0
    assert stats["preprocess_launches"] == 0  # the CPU runs the plain twin
    skeletons = {(t.params["n_conv_layers"], t.params["n_linear_layers"],
                  t.params["optimizer"]) for t in study.trials}
    assert len(skeletons) <= stats["waves"]
    model_cfg, _ = tspace.define_isic_model(
        tstudy.TrialReplay(study.best_params), image_size=16)
    out = tparallel.train_population(
        model_cfg, np.array([1e-3, 1e-2]), px[:40], labels[:40], px[40:],
        labels[40:], epochs=1, batch_size=8, device="cpu")
    assert out["accuracy_history"].shape == (1, 2)
    assert out["params"]["head.weight"].shape[0] == 2
    # over a mesh of two CPU positions (once refused until ROADMAP item
    # 12): one vmap group of lanes each, the same trials and values; the
    # population's two trials split one a position
    mesh = create_mesh(MeshConfig(data_parallel=2), devices=["cpu"] * 2)
    study2, stats2 = twave.run_wave_study(
        px, labels, cfg, study=tstudy.create_study(
            "maximize", sampler=tstudy.RandomSampler(2)),
        wave_size=2, width_range=(4, 8), verbose=False, mesh=mesh,
        device="cpu")
    assert [t.params for t in study2.trials] == [
        t.params for t in study.trials]
    assert [t.value for t in study2.trials] == pytest.approx(
        [t.value for t in study.trials], abs=1e-6)
    # K rounds up to a multiple of 2: filler lanes train, never told
    assert stats2["trials"] == stats["trials"]
    assert stats2["lane_epochs"] >= stats["lane_epochs"]
    out2 = tparallel.train_population(
        model_cfg, np.array([1e-3, 1e-2]), px[:40], labels[:40], px[40:],
        labels[40:], epochs=1, batch_size=8, mesh=mesh, device="cpu")
    np.testing.assert_allclose(out2["accuracy_history"],
                               out["accuracy_history"], atol=1e-6)
    for name, w in out["params"].items():
        torch.testing.assert_close(out2["params"][name], w, atol=1e-5,
                                   rtol=1e-5)
    if not torch.cuda.is_available():
        for call in (lambda: twave.run_wave_study(px, labels, cfg),
                     lambda: tobjective.make_objective(px, labels, cfg)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


# -- the CLIs ----------------------------------------------------------------


def test_optuna_cli_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    common = ["--epochs", "1", "--image-size", "8", "--batch-size", "8",
              "--sample-size", "48", "--device", "cpu"]
    assert tone_bias_optuna.main(["--trials", "2", "--sampler", "random",
                                  *common, "--sample-size", "40"]) == 0
    out = capsys.readouterr().out
    for line in ("Study statistics:", "  Number of finished trials: 2",
                 "Best trial value:", "Best params:",
                 "Wrote optuna_2_1_cpu_8_40.json"):
        assert line in out
    with open("optuna_2_1_cpu_8_40.json") as f:
        art = json.load(f)
    assert set(art) == ARTIFACT_KEYS and art["device"] == "cpu"
    assert tone_bias_optuna.main(["--trials", "2", "--parallel", "2",
                                  "--population", "2", *common]) == 0
    out = capsys.readouterr().out
    assert "waves: 1  trials: 2" in out
    assert "Population sweep (lr -> final val acc):" in out
    with open("optuna_2_1_cpu_8_48.json") as f:
        art = json.load(f)
    assert set(art) == ARTIFACT_KEYS | WAVE_KEYS
    # the artifact replays through both packages alike
    tm, _ = treplay.replay_artifact("optuna_2_1_cpu_8_48.json", 8)
    jm, _ = jreplay.replay_artifact("optuna_2_1_cpu_8_48.json", 8)
    assert (tm.conv_features, tm.linear_features, tm.dropout) == (
        jm.conv_features, jm.linear_features, jm.dropout)
    # --mesh (once refused until ROADMAP item 12) splits the wave's lanes
    with pytest.raises(SystemExit, match="--parallel"):
        tone_bias_optuna.main(["--mesh", "2", *common])
    assert tone_bias_optuna.main(["--trials", "2", "--parallel", "2",
                                  "--mesh", "2", *common]) == 0
    assert "waves: 1  trials: 2" in capsys.readouterr().out


def test_train_cli_from_hpo(tmp_path, monkeypatch, capsys):
    from tests.fixtures import make_synthetic_dataset

    root = str(tmp_path / "cohort")
    make_synthetic_dataset(root, n=24, seed=3, image_size=20)
    art = tmp_path / "optuna_ref.json"
    art.write_text(REFERENCE_ARTIFACT)
    monkeypatch.chdir(tmp_path)
    assert ttrain_cli.main([root, "1", "balance", "--from-hpo", str(art),
                            "--image-size", "16", "--batch-size", "4",
                            "--fp32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    jm, jo = jreplay.replay_artifact(str(art), image_size=16,
                                     compute_dtype="float32")
    assert (f"from-hpo: conv={jm.conv_features} "
            f"linear={jm.linear_features} "
            f"dropout={tuple(round(d, 3) for d in jm.dropout)} "
            f"{jo.optimizer} lr={jo.learning_rate:g}") in out
    folder = out.split("Experiment folder: ")[1].split()[0]
    with open(os.path.join(folder, "train_config.json")) as f:
        saved = json.load(f)
    assert tuple(saved["model"]["conv_features"]) == jm.conv_features
    assert tuple(saved["model"]["linear_features"]) == jm.linear_features
    assert saved["optim"]["optimizer"] == "adam"
    assert saved["optim"]["learning_rate"] == jo.learning_rate


def test_new_paths_without_jax(tmp_path):
    """HPO (a wave study and the objective), ``--from-hpo``'s replay, and
    int8 quantization (the capture and a quantized session) with jax,
    flax, optax and the JAX package unimportable."""
    art = tmp_path / "optuna_ref.json"
    art.write_text(REFERENCE_ARTIFACT)
    code = textwrap.dedent(f"""
        import os, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {_BLOCKED!r}:
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from skin_image_analysis_tpu_torch import config as c
        from skin_image_analysis_tpu_torch.cli import tone_bias_optuna
        from skin_image_analysis_tpu_torch.hpo.objective import (
            make_objective)
        from skin_image_analysis_tpu_torch.hpo.replay import replay_artifact
        from skin_image_analysis_tpu_torch.hpo.study import (
            RandomSampler, create_study)
        from skin_image_analysis_tpu_torch.hpo.wave import run_wave_study
        from skin_image_analysis_tpu_torch.models.cnn import build_model
        from skin_image_analysis_tpu_torch.serve.server import (
            InferenceSession)
        from skin_image_analysis_tpu_torch.train import checkpoint as ck
        os.chdir({str(tmp_path)!r})
        rng = np.random.default_rng(0)
        px = rng.integers(0, 256, (48, 16, 16, 3), np.uint8)
        lb = rng.integers(0, 2, 48)
        cfg = c.HpoConfig(trials=2, epochs=1, batch_size=8, sample_size=48)
        study, stats = run_wave_study(px, lb, cfg, wave_size=2,
                                      width_range=(4, 8), verbose=False,
                                      device="cpu")
        assert stats["trials"] == 2, stats
        study = create_study(sampler=RandomSampler(0))
        study.optimize(make_objective(px, lb, cfg, device="cpu"), 1)
        assert study.trials[0].state == "COMPLETE"
        mcfg, optim = replay_artifact({str(art)!r}, image_size=16)
        assert mcfg.conv_features == (24, 20, 16), mcfg
        small = c.ModelConfig(conv_features=(4, 8), linear_features=(8,),
                              dropout=(0.0,), image_size=16,
                              compute_dtype="float32")
        os.makedirs("exp")
        ck.save_model(os.path.join("exp", ck.MODEL_FILENAME), small,
                      build_model(small, device="cpu").state_dict())
        sess = InferenceSession.from_experiment_quantized(
            "exp", px[:8], device="cpu")
        assert np.isfinite(sess.predict(px[:4])["log_probs"]).all()
        assert not [m for m in sys.modules
                    if m.split(".")[0] in {_BLOCKED!r}]
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")

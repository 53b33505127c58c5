"""The port's scale-out (``parallel/``) against the JAX package's, on the
CPU: the counterparts of ``tests/test_sharding.py``,
``tests/test_multiprocess.py`` and ``tests/test_wave_mesh.py`` and of
``test_session_mesh_dp_serving``.

One 2-rank gloo cluster (``tests/_torch_mp_worker.py``, started once)
runs every data- and tensor-parallel case; its ranks are held against
JAX's ``make_train_step(mesh=...)`` on the 8-virtual-device CPU platform
and against the port's own single-process run, at float32, with JAX's
limits (1e-4). Serving and the HPO waves use in-process meshes of CPU
positions."""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu.hpo import wave as jwave
from skin_image_analysis_tpu.parallel import batch_sharding as jbatch_sharding
from skin_image_analysis_tpu.parallel import create_mesh as jcreate_mesh
from skin_image_analysis_tpu.parallel import (
    infer_param_shardings as jinfer_param_shardings,
)
from skin_image_analysis_tpu.serve import server as jserver
from skin_image_analysis_tpu.train import state as jstate
from skin_image_analysis_tpu.train import step as jstep
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch.config import HpoConfig, MeshConfig
from skin_image_analysis_tpu_torch.hpo import study as tstudy
from skin_image_analysis_tpu_torch.hpo import wave as twave
from skin_image_analysis_tpu_torch.parallel import (
    create_mesh,
    infer_param_shardings,
)
from skin_image_analysis_tpu_torch.parallel import distributed as tdist
from skin_image_analysis_tpu_torch.serve.server import InferenceSession
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from skin_image_analysis_tpu_torch.train import loop as tloop
from skin_image_analysis_tpu_torch.train.state import create_train_state
from skin_image_analysis_tpu_torch.utils import jsonl
from tests import _torch_mp_worker as W
from tests.fixtures import make_synthetic_dataset
from tests.test_torch_pooling import one_torch_thread  # noqa: F401
from tests.test_torch_train import _check_record

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JMODEL = jconfig.ModelConfig(**{f.name: getattr(W.MODEL, f.name)
                                for f in dataclasses.fields(W.MODEL)})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """Start the 2-rank cluster once: the step cases from the JAX
    package's init (``create_train_state(MODEL, ..., key(0))``, bridged),
    then ``run_training`` on a tiny cohort, data parallel, model parallel
    and streamed."""
    work = str(tmp_path_factory.mktemp("cluster"))
    root = os.path.join(work, "cohort")
    make_synthetic_dataset(root, n=48, seed=5, image_size=40)
    jst, _ = jstate.create_train_state(JMODEL, jconfig.OptimConfig(
        learning_rate=1e-2), jax.random.key(0), batch_size=2)
    init = os.path.join(work, "init.pt")
    torch.save(bridge.flax_to_state_dict(
        jax.tree.map(np.asarray, jst.params), 64), init)
    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump({"root": root, "shard_rows": 7,
                   "init": {name: init for name in W.STEP_CASES
                            if W.STEP_CASES[name][1]["kind"] == "step"}}, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_mp_worker.py"),
         str(rank), "2", str(port), work],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for rank in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]
    return {"work": work, "root": root, "init": init, "outs": outs,
            "jax_params": jax.tree.map(np.asarray, jst.params)}


# -- meshes, specs and the process arithmetic --------------------------------


def test_create_mesh_shapes():
    cpus = ["cpu"] * 8
    mesh = create_mesh(MeshConfig(data_parallel=-1, model_parallel=2), cpus)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.shape == jcreate_mesh(jconfig.MeshConfig(
        data_parallel=-1, model_parallel=2)).shape
    mesh = create_mesh(MeshConfig(data_parallel=8, model_parallel=1), cpus)
    assert mesh.shape == {"data": 8, "model": 1}
    assert not mesh.is_process_mesh and mesh.local_devices == [
        torch.device("cpu")] * 8
    for cfg in (MeshConfig(data_parallel=3, model_parallel=2),
                MeshConfig(data_parallel=-1, model_parallel=3)):
        with pytest.raises(ValueError):
            create_mesh(cfg, cpus)
        with pytest.raises(ValueError):
            jcreate_mesh(jconfig.MeshConfig(**dataclasses.asdict(cfg)))
    # one process without a group: a 1 x 1 mesh of the current card, and
    # of the CPU only when the caller passes it
    if torch.cuda.is_available():
        assert create_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_mesh()
    one = create_mesh(devices=["cpu"])
    assert one.shape == {"data": 1, "model": 1}
    assert one.device == torch.device("cpu")


def test_infer_param_shardings_tp():
    """JAX's rule on its MODEL: the 4 * 32 * 32 x 256 flatten kernel is
    column-parallel (the port's [out, in] weight reverses the spec),
    everything else replicated; a pure-DP mesh replicates all."""
    state = create_train_state(W.MODEL, W.C.OptimConfig(), 0, "cpu")
    params = dict(state.model.named_parameters())
    mesh = create_mesh(MeshConfig(data_parallel=-1, model_parallel=2),
                       ["cpu"] * 8)
    specs = {k: s.spec for k, s in infer_param_shardings(params,
                                                         mesh).items()}
    assert specs["mlp_blocks.0.weight"] == ("model", None)
    assert {k for k, s in specs.items() if s} == {"mlp_blocks.0.weight"}
    jspecs = jax.tree_util.tree_flatten_with_path(jinfer_param_shardings(
        jax.eval_shape(lambda: jstate.create_train_state(
            JMODEL, jconfig.OptimConfig(), jax.random.key(0))[0].params),
        jcreate_mesh(jconfig.MeshConfig(data_parallel=-1,
                                        model_parallel=2))))[0]
    split = [tuple(s.spec) for _, s in jspecs if tuple(s.spec)]
    assert split == [tuple(reversed(specs["mlp_blocks.0.weight"]))]
    dp = create_mesh(MeshConfig(data_parallel=8), ["cpu"] * 8)
    assert not any(s.spec for s in infer_param_shardings(params,
                                                         dp).values())
    # two qualifying kernels: column-, then row-parallel
    rows = create_train_state(W.ROW_MODEL, W.C.OptimConfig(), 0, "cpu")
    specs = infer_param_shardings(dict(rows.model.named_parameters()), mesh)
    assert [(k, s.spec) for k, s in specs.items() if s.spec] == [
        ("mlp_blocks.0.weight", ("model", None)),
        ("mlp_blocks.1.weight", (None, "model"))]


def test_process_shard_partitions_exactly(monkeypatch):
    for p in (1, 2, 3, 5):
        for n in (0, 1, 7, 8, 23):
            seen = []
            monkeypatch.setattr(tdist, "process_count", lambda p=p: p)
            for i in range(p):
                monkeypatch.setattr(tdist, "process_index", lambda i=i: i)
                lo, hi = tdist.process_shard(n)
                seen.extend(range(lo, hi))
            assert seen == list(range(n)), (p, n, seen)


def test_maybe_initialize_needs_all_three_variables(monkeypatch):
    for var in ("SIA_COORDINATOR", "SIA_NUM_PROCESSES", "SIA_PROCESS_ID",
                "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.maybe_initialize(device="cpu") is False  # one process
    monkeypatch.setenv("SIA_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SIA_PROCESS_ID", "0")
    with pytest.raises(ValueError, match="SIA_NUM_PROCESSES"):
        tdist.maybe_initialize(device="cpu")
    with pytest.raises(ValueError, match="one row count"):
        tdist.global_batch(create_mesh(devices=["cpu"]),
                           {"a": np.zeros(2), "b": np.zeros(3)})


def test_cluster_places(cluster):
    outs = cluster["outs"]
    assert [o["info"] for o in outs] == [
        {"process_index": r, "process_count": 2, "local_devices": 1,
         "global_devices": 2} for r in range(2)]
    assert [o["shard"] for o in outs] == [(0, 4), (4, 7)]


# -- the steps ---------------------------------------------------------------


def _jax_steps(name, jax_params):
    """JAX's mesh step on 8 virtual devices: the case's losses and final
    params (bridged to the port's names)."""
    shape, case = W.STEP_CASES[name]
    mesh = jcreate_mesh(jconfig.MeshConfig(
        data_parallel=8 if shape[1] == 1 else -1, model_parallel=shape[1]))
    state, _ = jstate.create_train_state(
        JMODEL, jconfig.OptimConfig(learning_rate=case["lr"],
                                    optimizer=case["optimizer"]),
        jax.random.key(0), batch_size=2)
    state = state.replace(params=jax.device_put(
        jax_params, jinfer_param_shardings(jax_params, mesh)))
    batch = jax.device_put(
        {k: jnp.asarray(v) for k, v in W.step_batch(
            case["seed"], case["batch"], case.get("uneven")).items()},
        jbatch_sharding(mesh))
    step = jstep.make_train_step(
        class_weights=W.WEIGHTS if case.get("weights") else None, mesh=mesh)
    losses = []
    for _ in range(case["steps"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, bridge.flax_to_state_dict(
        jax.tree.map(np.asarray, state.params), 64)


def _check_ranks(cluster, name):
    """Both ranks' results, bit-equal (replicated state); rank 0's."""
    a, b = (o[name] for o in cluster["outs"])
    assert a["steps"] == b["steps"] and a["step"] == b["step"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    return a


def _close(got: dict, want: dict, losses=1e-4, params=1e-4):
    gl = [s["loss"] for s in got["steps"]]
    np.testing.assert_allclose(gl, want["losses"], rtol=losses, atol=0)
    for k, w in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), np.asarray(w),
                                   atol=params, rtol=params, err_msg=k)


@pytest.mark.parametrize("name", ["dp", "tp", "dp_masked", "tp_masked"])
def test_two_ranks_match_jax_mesh_and_one_process(cluster, name):
    """2-way DP and TP (data 1, model 2) against JAX's mesh step (8-way
    DP; TP data 4 x model 2) and the port's single-process step, from the
    same weights (JAX's cases under sgd, ``_torch_mp_worker`` says why).
    The masked cases put five invalid rows in the first
    rank's half and none in the second, with class weights (0.3, 1.7):
    the loss divides by the global weight, not a mean of local means."""
    got = _check_ranks(cluster, name)
    losses, params = _jax_steps(name, cluster["jax_params"])
    _close(got, {"losses": losses, "params": params})
    single = W.run_case(dict(W.STEP_CASES[name][1], init=cluster["init"]))
    _close(got, {"losses": [s["loss"] for s in single["steps"]],
                 "params": single["params"]})
    assert [(s["correct"], s["count"]) for s in got["steps"]] == [
        (s["correct"], s["count"]) for s in single["steps"]]
    if "masked" in name:
        assert got["steps"][0]["count"] == W.GLOBAL_B - 5


@pytest.mark.parametrize("name", ["dp_local", "dp_aug", "tp_aug",
                                  "tp_rows"])
def test_two_ranks_match_one_process(cluster, name):
    """``global_batch`` of each rank's ``process_shard`` rows through
    ``make_train_step`` (the JAX ``_mp_worker`` flow), and the augmented
    multi-step path: random crop, flip, jitter and dropout 0.5 drawn for
    the whole batch on every rank, class weights, invalid rows and an
    inert padding step; ``tp_rows`` with a column- then a row-parallel
    Dense. Held to the single-process run: losses to 1e-5 relative,
    params to 1e-4."""
    got = _check_ranks(cluster, name)
    case = W.STEP_CASES[name][1]
    single = W.run_case(dict(case, init=cluster["init"]
                             if case["kind"] == "step" else None))
    _close(got, {"losses": [s["loss"] for s in single["steps"]],
                 "params": single["params"]}, losses=1e-5)
    assert [(s["correct"], s["count"]) for s in got["steps"]] == [
        (s["correct"], s["count"]) for s in single["steps"]]
    assert got["step"] == single["step"]
    if name != "dp_local":
        assert [s["count"] for s in got["steps"]][-1] == 0  # inert


# -- whole runs --------------------------------------------------------------


def _records(folder):
    names = sorted(n for n in os.listdir(folder)
                   if n.endswith(".json") and n[0].isdigit())
    return [r for n in names
            for r in jsonl.read_records(os.path.join(folder, n))]


@pytest.mark.parametrize("name", sorted(W.RUN_CASES))
def test_run_training_over_two_ranks(cluster, tmp_path, name):
    """``run_training`` under 2 ranks (data parallel, the flatten Dense
    split over the model axis, and streamed) against the single-process
    folder: one folder, written by rank 0, with the single-process
    layout; confusion counts and DI exact, losses, AUCs and the saved
    weights within 1e-4. Streamed with the cache, both ranks decode each
    split in the first epoch only and read rank 0's cache in the
    second."""
    mp, streaming = W.RUN_CASES[name]
    a, b = (o[name] for o in cluster["outs"])
    assert a == b and os.listdir(os.path.dirname(a)) == [
        os.path.basename(a)]
    counts = [o["stream_counts"][name] for o in cluster["outs"]]
    if streaming:
        assert counts[0] == counts[1] and len(counts[0]) == 2
        assert all(decoded == cached > 0 for decoded, cached in counts[0])
    else:
        assert counts == [[], []]
    single = tloop.run_training(
        W.run_config(cluster["root"], str(tmp_path), streaming),
        verbose=False, device="cpu")
    def layout(folder):
        return sorted(n for n in os.listdir(folder) if not n[0].isdigit())

    assert layout(a) == layout(single)
    got, want = _records(a), _records(single)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _check_record(g, {k: v for k, v in w.items()
                          if k not in tloop.RECORD_KEYS[-2:]},
                      lambda k: 1e-4 if k == "avg_batch_loss"
                      or k.startswith("auc") else 0.0)
    for fname in (tckpt.MODEL_FILENAME,):
        (cfg_g, sd_g), (cfg_w, sd_w) = (tckpt.load_model(
            os.path.join(f, fname)) for f in (a, single))
        assert cfg_g == cfg_w and sd_g.keys() == sd_w.keys()
        for k in sd_w:
            assert sd_g[k].shape == sd_w[k].shape
            torch.testing.assert_close(sd_g[k], sd_w[k], atol=1e-4,
                                       rtol=1e-4)
    snap = tckpt.read_train_state(os.path.join(a, tloop.CHECKPOINT_DIRNAME))
    want_snap = tckpt.read_train_state(os.path.join(
        single, tloop.CHECKPOINT_DIRNAME))
    assert snap["step"] == want_snap["step"]
    for key, tensors in want_snap["opt_state"].items():
        for t, w in zip(snap["opt_state"][key], tensors):
            assert t.shape == w.shape  # the split moments gathered whole


# -- serving -----------------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A trained folder at 32² (the tiny cohort's single-process run)."""
    tmp = tmp_path_factory.mktemp("served")
    root = str(tmp / "cohort")
    make_synthetic_dataset(root, n=48, seed=5, image_size=40)
    cfg = dataclasses.replace(W.run_config(root, str(tmp / "runs")),
                              epochs=1, checkpoint_every=0)
    return tloop.run_training(cfg, verbose=False, device="cpu")


def test_session_mesh_dp_serving(served, tmp_path):
    """JAX's ``test_session_mesh_dp_serving`` cases: over 8 positions the
    ladder is [8, 16, 32] and a cap of 4 cannot shard; over two, each
    batch splits in two replicas and the answers equal the one-device
    session's and the JAX session's. A hot reload swaps every replica."""
    eight = create_mesh(MeshConfig(data_parallel=8), ["cpu"] * 8)
    assert InferenceSession.from_experiment(
        served, max_batch=32, mesh=eight, device="cpu").buckets == [8, 16, 32]
    with pytest.raises(ValueError, match="cannot shard"):
        InferenceSession.from_experiment(served, max_batch=4, mesh=eight,
                                         device="cpu")
    two = create_mesh(MeshConfig(data_parallel=2), ["cpu"] * 2)
    sharded = InferenceSession.from_experiment(served, max_batch=32,
                                               mesh=two, device="cpu")
    assert sharded.buckets == [2, 4, 8, 16, 32]
    plain = InferenceSession.from_experiment(served, max_batch=32,
                                             device="cpu")
    jplain = jserver.InferenceSession.from_experiment(served, max_batch=32)
    rng = np.random.default_rng(9)
    for nrows in (3, 8, 20):
        px = rng.integers(0, 255, (nrows, 32, 32, 3), np.uint8)
        got = sharded.predict(px)
        for ref in (plain.predict(px), jplain.predict(px)):
            np.testing.assert_allclose(got["log_probs"], ref["log_probs"],
                                       atol=1e-5)
            np.testing.assert_array_equal(got["pred"], ref["pred"])
    assert sharded.compiled <= {4, 8, 32}

    other = str(tmp_path / "other")
    shutil.copytree(served, other)
    model_cfg, sd = tckpt.load_model(os.path.join(other,
                                                  tckpt.MODEL_FILENAME))
    tckpt.save_model(os.path.join(other, tckpt.MODEL_FILENAME), model_cfg,
                     {k: v * 1.5 for k, v in sd.items()})
    sharded.reload_weights(other)
    px = rng.integers(0, 255, (8, 32, 32, 3), np.uint8)
    want = InferenceSession.from_experiment(other, device="cpu").predict(px)
    np.testing.assert_allclose(sharded.predict(px)["log_probs"],
                               want["log_probs"], atol=1e-5)


# -- the HPO waves -----------------------------------------------------------


def _toy_data(n=96, size=16, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n).astype(np.int32)
    pixels = (rng.normal(0, 0.05, (n, size, size, 3))
              + labels[:, None, None, None] * 0.5 + 0.25)
    return (np.clip(pixels, 0, 1) * 255).astype(np.uint8), labels


def _wave(mesh, pixels, labels, cfg, wave_size=8, **kw):
    return twave.run_wave_study(
        pixels, labels, cfg, image_size=16, compute_dtype="float32",
        study=tstudy.create_study("maximize",
                                  sampler=tstudy.RandomSampler(0)),
        wave_size=wave_size,
        mesh=mesh, verbose=False, width_range=(4, 16), device="cpu", **kw)


def test_run_wave_study_over_mesh():
    """JAX's ``test_run_wave_study_over_mesh`` and the sharded-equals-
    unsharded check: over 8 positions the study finishes its trials with
    at most one extra (overflow lanes ride as fillers), and over 2 every
    trial is the one-device wave's, its value too."""
    pixels, labels = _toy_data(n=120)
    cfg = HpoConfig(trials=9, sample_size=90, batch_size=8, epochs=2,
                    seed=0, n_train_examples=16, n_valid_examples=8)
    eight = create_mesh(MeshConfig(data_parallel=8), ["cpu"] * 8)
    study, stats = _wave(eight, pixels, labels, cfg)
    assert cfg.trials <= len(study.trials) <= cfg.trials + 1
    for t in study.trials:
        assert t.state in ("COMPLETE", "PRUNED")
        if t.value is not None:
            assert 0.0 <= t.value <= 1.0
    assert stats["lane_epochs"] > 0 and stats["lane_epochs"] % 8 == 0
    small = dataclasses.replace(cfg, trials=4)
    one, _ = _wave(None, pixels, labels, small, wave_size=4)
    two, _ = _wave(create_mesh(MeshConfig(data_parallel=2), ["cpu"] * 2),
                   pixels, labels, small, wave_size=4)
    assert [t.params for t in two.trials] == [t.params for t in one.trials]
    assert [t.value for t in two.trials] == pytest.approx(
        [t.value for t in one.trials], abs=1e-6)


def test_mesh_rejects_too_small_population(monkeypatch):
    """A skeleton whose padded footprint fits fewer lanes than the mesh
    has devices fails loudly in both packages."""
    pixels, labels = _toy_data(n=60)
    cfg = HpoConfig(trials=4, sample_size=48, batch_size=8, epochs=1,
                    seed=0, n_train_examples=8, n_valid_examples=8)
    monkeypatch.setattr(twave, "max_population", lambda *a, **kw: 4)
    monkeypatch.setattr(jwave, "max_population", lambda *a, **kw: 4)
    with pytest.raises(ValueError, match="mesh has 8 devices"):
        _wave(create_mesh(MeshConfig(data_parallel=8), ["cpu"] * 8),
              pixels, labels, cfg)
    with pytest.raises(ValueError, match="mesh has 8 devices"):
        jwave.run_wave_study(
            pixels, labels, jconfig.HpoConfig(**dataclasses.asdict(cfg)),
            image_size=16, compute_dtype="float32", wave_size=8,
            mesh=jax.sharding.Mesh(np.asarray(jax.devices()[:8]),
                                   ("trial",)), verbose=False)

"""Data-parallel training of the BatchNorm families on the CPU: the
port's ``BatchNorm`` under ``global_batch_stats`` and resnet18 steps and
runs over a 2-rank gloo cluster (``tests/_torch_bn_worker.py``, started
once), against Flax's ``BatchNorm`` on the concatenated batch, JAX's
step on a two-device mesh (where GSPMD computes the global batch's
statistics) and the port's single process; and each family's
``draw_dropout_noise`` against its generator's draws."""

import json
import os
import socket
import subprocess
import sys

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu.parallel import batch_sharding as jbatch_sharding
from skin_image_analysis_tpu.parallel import create_mesh as jcreate_mesh
from skin_image_analysis_tpu.train import step as jstep
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from skin_image_analysis_tpu_torch.train import loop as tloop
from skin_image_analysis_tpu_torch.train.state import create_train_state
from skin_image_analysis_tpu_torch.train.step import train_step
from tests import _torch_bn_worker as W
from tests.fixtures import make_synthetic_dataset
from tests.test_torch_pooling import one_torch_thread  # noqa: F401
from tests.test_torch_resnet import (
    jax_create_train_state,
    jax_variables,
    nodrop_models,
)
from tests.test_torch_train import _check_record

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """Run the worker's cases once on two ranks: the layer cases, two
    resnet18 steps from JAX's perturbed init (the last BatchNorm of each
    block at 0.2 of its random scale, ``tests/test_torch_resnet.py`` says
    why), the augmented steps and ``run_training``."""
    work = str(tmp_path_factory.mktemp("bn_cluster"))
    root = os.path.join(work, "cohort")
    make_synthetic_dataset(root, n=40, seed=6, image_size=40)
    _, params, stats = jax_variables(W.NODROP, last_scale=0.2)
    init = os.path.join(work, "init.pt")
    torch.save(bridge.variables_to_state_dict(params, stats, W.SIDE), init)
    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump({"root": root, "init": init}, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_bn_worker.py"),
         str(rank), "2", str(port), work],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for rank in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]
    return {"root": root, "init": init, "outs": outs, "params": params,
            "stats": stats}


# -- the layer ---------------------------------------------------------------


def _flax_bn(name):
    """Flax's BatchNorm in train mode on the case's whole batch (NHWC):
    output, the vjp of the cotangent to x, scale and bias, and the new
    batch_stats, all in the port's NCHW."""
    rows, _, _ = W.BN_CASES[name]
    x, g, w, b, rm, rv = W.bn_data(rows)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-5)
    stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}

    def f(xn, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, xn,
                          mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, vjp, new = jax.vjp(f, jnp.asarray(x.transpose(0, 2, 3, 1)),
                          jnp.asarray(w), jnp.asarray(b), has_aux=True)
    dx, dw, db = vjp(jnp.asarray(g.transpose(0, 2, 3, 1)))
    return {"y": np.asarray(y).transpose(0, 3, 1, 2),
            "dx": np.asarray(dx).transpose(0, 3, 1, 2),
            "dw": np.asarray(dw), "db": np.asarray(db),
            "running_mean": np.asarray(new["mean"]),
            "running_var": np.asarray(new["var"])}


def _joined(cluster, name):
    """Both ranks' layer results as one batch: rows concatenated,
    parameter gradients summed, running stats equal on both ranks."""
    a, b = (o[name] for o in cluster["outs"])
    for key in ("running_mean", "running_var"):
        assert torch.equal(a[key], b[key]), key
    return {"y": torch.cat([a["y"], b["y"]]).numpy(),
            "dx": torch.cat([a["dx"], b["dx"]]).numpy(),
            "dw": (a["dw"] + b["dw"]).numpy(),
            "db": (a["db"] + b["db"]).numpy(),
            "running_mean": a["running_mean"].numpy(),
            "running_var": a["running_var"].numpy()}


@pytest.mark.parametrize("name", ["even", "uneven"])
def test_batchnorm_over_two_ranks_matches_flax_on_the_whole_batch(cluster,
                                                                  name):
    """4 + 4 and 3 + 5 rows: the output, dx, dscale and dbias, and the
    running statistics equal Flax's on the 8 rows (float32: 2e-5 on
    the outputs and gradients, whose channel sums two reductions round
    differently; 1e-6 on the statistics), and so do the port's single
    process's."""
    got = _joined(cluster, name)
    want = _flax_bn(name)
    rows, _, _ = W.BN_CASES[name]
    single = {k: v.numpy() for k, v in W.bn_case(name, 0, rows).items()}
    for ref in (want, single):
        for key in ("y", "dx", "dw", "db"):
            np.testing.assert_allclose(got[key], ref[key], atol=2e-5,
                                       rtol=1e-5, err_msg=key)
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[key], ref[key], atol=1e-6,
                                       rtol=0, err_msg=key)


def test_bf16_batchnorm_over_two_ranks_matches_one_process(cluster):
    """bf16 activations into the float32 statistics: the two ranks'
    output within one bf16 rounding of the single process's (its
    statistics add the same values in another order), the statistics to
    1e-6."""
    got = _joined(cluster, "bf16")
    single = {k: v.numpy() for k, v in W.bn_case("bf16", 0, 8).items()}
    scale = np.abs(single["y"]).max()
    np.testing.assert_allclose(got["y"], single["y"], atol=scale * 2 ** -8,
                               rtol=0)
    for key in ("dw", "db"):
        np.testing.assert_allclose(got[key], single[key], rtol=2e-2,
                                   atol=2e-2 * np.abs(single[key]).max())
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(got[key], single[key], atol=1e-6, rtol=0)


# -- resnet18 steps ----------------------------------------------------------


def _both_ranks(cluster, name):
    a, b = (o[name] for o in cluster["outs"])
    assert a["steps"] == b["steps"] and a["step"] == b["step"]
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
    return a


def _jax_mesh_steps(cluster, lr=1e-2):
    """JAX's make_train_step on a two-device mesh, resnet18 without head
    dropout, from the same perturbed variables: losses and the final
    state as the port's state_dict."""
    with nodrop_models() as name:
        state, _ = jax_create_train_state(
            jconfig.ModelConfig(name=name, image_size=W.SIDE,
                                compute_dtype="float32"),
            jconfig.OptimConfig(optimizer="sgd", learning_rate=lr),
            jax.random.key(0), batch_size=W.GLOBAL_B)
        params = jax.tree.map(jnp.asarray, cluster["params"])
        state = state.replace(params=params,
                              opt_state=state.tx.init(params),
                              batch_stats=jax.tree.map(jnp.asarray,
                                                       cluster["stats"]))
        mesh = jcreate_mesh(jconfig.MeshConfig(data_parallel=2),
                            devices=jax.devices()[:2])
        batch = jax.device_put(
            {k: jnp.asarray(v) for k, v in W.resnet_batch().items()},
            jbatch_sharding(mesh))
        step = jstep.make_train_step(mesh=mesh)
        losses = []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return losses, bridge.variables_to_state_dict(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats), W.SIDE)


def test_resnet18_steps_over_two_ranks_match_jax_mesh_and_one_process(
        cluster):
    """Two sgd steps (lr 1e-2, float32, one invalid row) over 4 + 4
    rows against JAX's two-device mesh and the port's single process on
    all 8: losses to 1e-5 relative, every parameter and running statistic
    to 1e-5 (the one-step parity of tests/test_torch_resnet.py holds JAX
    to 1e-5 and its statistics to 1e-6)."""
    got = _both_ranks(cluster, "resnet_step")
    losses, want = _jax_mesh_steps(cluster)
    single = W.resnet_step_case(cluster["init"])
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-5)
    assert [s["count"] for s in got["steps"]] == [W.GLOBAL_B - 1] * 2
    for ref in (want, single["state"]):
        assert got["state"].keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_allclose(got["state"][k].numpy(),
                                       np.asarray(v), atol=1e-5, rtol=0,
                                       err_msg=k)
    moved = [k for k in want if "running" in k
             and not torch.equal(got["state"][k], torch.load(
                 cluster["init"])[k])]
    assert len(moved) == sum("running" in k for k in want)


def test_augmented_resnet18_steps_over_two_ranks_match_one_process(cluster):
    """resnet18 with head dropout 0.5, sgd, the fused preprocess's
    random crops, flips and jitter and the head dropout drawn for the
    whole batch on each rank, class weights, an invalid row and an inert
    step: losses to 1e-5 relative, parameters and running statistics to
    1e-5."""
    got = _both_ranks(cluster, "resnet_aug")
    single = W.resnet_aug_case()
    assert [(s["correct"], s["count"]) for s in got["steps"]] == [
        (s["correct"], s["count"]) for s in single["steps"]]
    assert got["steps"][-1]["count"] == 0 and got["step"] == single["step"]
    np.testing.assert_allclose(got["losses"], single["losses"], rtol=1e-5)
    for k, v in single["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_a_model_without_the_dropout_draws_is_refused_by_name(cluster):
    """Under a process mesh a model lacking ``draw_dropout_noise`` or a
    forward taking ``dropout_noise`` raises NotImplementedError naming
    what is missing; every registry family has both."""
    from skin_image_analysis_tpu_torch.models import registry
    from skin_image_analysis_tpu_torch.models.cnn import build_model

    for name in sorted(registry._REGISTRY):
        model = build_model(tconfig.ModelConfig(name=name, image_size=32),
                            device="meta")
        assert hasattr(model, "draw_dropout_noise"), name

    class Plain(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(3, 2))

        def forward(self, x, *, train=False, generator=None):
            return torch.log_softmax(x.mean(dim=(1, 2)) @ self.w, -1)

    class FakeMesh:
        shape = {"data": 1}

        def axis_index(self, axis):
            return 0

        def all_reduce(self, t, axis):
            return t

    state = create_train_state(tconfig.ModelConfig(
        conv_features=(4,), linear_features=(8,), dropout=(0.0,),
        image_size=8, compute_dtype="float32"), tconfig.OptimConfig(), 0,
        "cpu")
    state.model = Plain()
    x = torch.zeros(2, 8, 8, 3)
    with pytest.raises(NotImplementedError,
                       match="draw_dropout_noise method and a forward that "
                             "takes dropout_noise; Plain lacks it"):
        train_step(state, x, torch.zeros(2, dtype=torch.int32),
                   mesh=FakeMesh())


# -- run_training ------------------------------------------------------------


def _records(folder):
    from skin_image_analysis_tpu_torch.utils import jsonl

    return [r for n in sorted(os.listdir(folder)) if n[0].isdigit()
            for r in jsonl.read_records(os.path.join(folder, n))]


def test_run_training_resnet18_over_two_ranks(cluster, tmp_path):
    """``run_training`` with ``model.name="resnet18"``, augmented and
    ImageNet-normalized, over two ranks against one process: one folder
    written by rank 0 with the single-process layout, confusion counts
    and DI exact, losses and AUCs to 1e-4, the saved weights and running
    statistics to 1e-4."""
    a, b = (o["run"] for o in cluster["outs"])
    assert a == b and os.listdir(os.path.dirname(a)) == [
        os.path.basename(a)]
    single = tloop.run_training(W.run_config(cluster["root"], str(tmp_path)),
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
    (cfg_g, sd_g), (cfg_w, sd_w) = (tckpt.load_model(
        os.path.join(f, tckpt.MODEL_FILENAME)) for f in (a, single))
    assert cfg_g == cfg_w and cfg_g.name == "resnet18"
    assert sd_g.keys() == sd_w.keys()
    assert any("running_var" in k for k in sd_g)
    for k in sd_w:
        torch.testing.assert_close(sd_g[k], sd_w[k], atol=1e-4, rtol=1e-4)


# -- each family's dropout draws ----------------------------------------------


@pytest.mark.parametrize("name", [
    "resnet18", "xception_small", "vgg16", "resnet50_v2", "mobilenet_v2",
    "efficientnet_b0", "efficientnet_v2_b0"])
def test_drawn_dropout_noise_replays_the_generator(name):
    """``draw_dropout_noise`` draws what a train-mode forward draws from
    the generator, in its order (the EfficientNets' stochastic-depth
    masks, then the head's): the forward given those draws equals the
    forward with the generator, bit for bit, and leaves the generator
    where that forward leaves it."""
    from skin_image_analysis_tpu_torch.models.cnn import build_model

    cfg = tconfig.ModelConfig(name=name, image_size=32,
                              compute_dtype="float32")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    outs, gens = [], []
    for drawn in (False, True):
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(5)
        if drawn:
            noise = model.draw_dropout_noise(4, gen, "cpu")
            assert noise and all(u.shape[0] == 4 for u in noise)
            outs.append(model(x, train=True, dropout_noise=noise))
        else:
            outs.append(model(x, train=True, generator=gen))
        gens.append(gen.get_state())
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(gens[0], gens[1])

"""The port's msgpack codec and checkpoints against the JAX package's, on
the CPU: ``session_model.msgpack`` byte-equal in both directions with the
weights exact, chunked arrays, the port's train-state snapshot restored
bit for bit, and a JAX-made snapshot refused."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization as flax_serialization

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu.train import checkpoint as jckpt
from skin_image_analysis_tpu.train import state as jstate
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.ops.preprocess import (
    AugmentConfig,
    make_preprocess_fn,
)
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from skin_image_analysis_tpu_torch.train import state as tstate
from skin_image_analysis_tpu_torch.train import step as tstep
from skin_image_analysis_tpu_torch.utils import serialization
from tests.test_torch_train import SMALL_MODEL
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_params(model_kw, seed=0):
    cfg = jconfig.ModelConfig(**model_kw)
    state, _ = jstate.create_train_state(cfg, jconfig.OptimConfig(),
                                         jax.random.key(seed))
    return cfg, state.params


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("model_kw", [
    SMALL_MODEL, dict(name="skin_cancer", image_size=32,
                      compute_dtype="float32"),
], ids=["skin_cancer_list", "skin_cancer"])
def test_session_model_byte_equal_both_ways(tmp_path, model_kw):
    """JAX file -> port load: the bridged weights exactly; port save of
    them -> the same bytes. Port file -> JAX load: the port's weights
    exactly; JAX save of them -> the same bytes."""
    jcfg, params = _jax_params(model_kw)
    jax_file = str(tmp_path / "jax.msgpack")
    jckpt.save_model(jax_file, jcfg, params)
    tcfg, sd = tckpt.load_model(jax_file)
    assert tconfig.to_dict(tcfg) == jconfig.to_dict(jcfg)
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, params),
                                     jcfg.image_size)
    assert sd.keys() == want.keys()
    for k in sd:
        assert torch.equal(sd[k], want[k]), k
    port_file = str(tmp_path / "port.msgpack")
    tckpt.save_model(port_file, tcfg, sd)
    assert open(port_file, "rb").read() == open(jax_file, "rb").read()

    model = build_model(tconfig.ModelConfig(**model_kw), device="cpu",
                        generator=torch.Generator().manual_seed(3))
    tckpt.save_model(port_file, tcfg, model.state_dict())
    _, loaded = jckpt.load_model(port_file)
    got = _flat(jax.tree.map(np.asarray, loaded))
    ref = _flat(bridge.state_dict_to_flax(
        model.state_dict(), 32, wrap=model_kw.get("name") == "skin_cancer"))
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    jckpt.save_model(jax_file, jcfg, loaded)
    assert open(jax_file, "rb").read() == open(port_file, "rb").read()


def test_chunked_arrays_round_trip(tmp_path, monkeypatch):
    """With flax's MAX_CHUNK_SIZE lowered to 4 KiB (and the port's with
    it) the first dense kernel (32 KiB) is stored in chunks: the files are
    byte-equal and load in both packages exactly."""
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    jcfg, params = _jax_params(SMALL_MODEL)
    jax_file, port_file = str(tmp_path / "j"), str(tmp_path / "p")
    jckpt.save_model(jax_file, jcfg, params)
    blob = open(jax_file, "rb").read()
    assert serialization.CHUNKED.encode() in blob
    tcfg, sd = tckpt.load_model(jax_file)
    tckpt.save_model(port_file, tcfg, sd)
    assert open(port_file, "rb").read() == blob
    dense = np.asarray(params["MlpBlock_0"]["Dense_0"]["kernel"])
    assert dense.nbytes > 4096
    raw = serialization.msgpack_restore(blob[blob.index(b"\x81\xa6params"):])
    np.testing.assert_array_equal(
        raw["params"]["MlpBlock_0"]["Dense_0"]["kernel"], dense)
    _, back = jckpt.load_model(port_file)
    np.testing.assert_array_equal(
        np.asarray(back["MlpBlock_0"]["Dense_0"]["kernel"]), dense)


@pytest.mark.parametrize("tree", [
    {"a": np.float32(2.5), "b": np.int64(-7), "c": np.zeros((0, 3))},
    {"x": [1, 2.5, None, True, "s" * 40, b"\x00" * 300, -2**40, 2**63]},
    {"f": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
     "m": {str(i): np.arange(i, dtype=np.uint8) for i in range(20)}},
], ids=["scalars", "python", "layouts"])
def test_codec_matches_flax(tree):
    blob = flax_serialization.to_bytes(tree)
    assert serialization.to_bytes(tree) == blob
    assert str(serialization.msgpack_restore(blob)) == str(
        flax_serialization.msgpack_restore(blob))


def test_corrupt_model_files_raise_value_error(tmp_path):
    jcfg, params = _jax_params(SMALL_MODEL)
    path = str(tmp_path / "m")
    jckpt.save_model(path, jcfg, params)
    blob = open(path, "rb").read()
    for bad in (b"XXXX" + blob[4:], blob[:6], blob[:-9], blob + b"\x00"):
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError):
            tckpt.load_model(path)


def test_batch_stats_models_are_refused(tmp_path):
    """Batch statistics that fit no BatchNorm of the model (a flagship
    file carrying some) are refused; a ResNet's load, as
    ``tests/test_torch_resnet.py`` holds."""
    jcfg, params = _jax_params(SMALL_MODEL)
    path = str(tmp_path / "m")
    jckpt.save_model(path, jcfg, params,
                     batch_stats={"bn": {"mean": jnp.zeros(3)}})
    with pytest.raises(ValueError, match="without BatchNorm"):
        tckpt.load_model(path)


def _trained_state(seed, steps):
    cfg = tconfig.ModelConfig(**dict(SMALL_MODEL, dropout=(0.5,)))
    state = tstate.create_train_state(
        cfg, tconfig.OptimConfig(learning_rate=1e-3,
                                 moment_dtype="bfloat16"), seed, "cpu")
    rng = np.random.default_rng(seed)
    arena = torch.from_numpy(rng.integers(0, 256, (8, 3, 36, 36),
                                          dtype=np.uint8))
    pre = make_preprocess_fn(32, train=True, layout="planar",
                             augment=AugmentConfig(brightness=0.1,
                                                   contrast=0.1,
                                                   saturation=0.1))
    idx = rng.integers(0, 8, (steps, 4)).astype(np.int32)
    labels = idx % 2
    tstep.multi_train_step(state, arena, idx, labels,
                           np.ones_like(idx, bool), None, pre)
    return state, arena, pre


def test_train_state_restores_bit_for_bit(tmp_path):
    """A snapshot restored into a fresh state: every tensor, the adam
    count, the step and the generator equal; then both states train on
    identically."""
    state, arena, pre = _trained_state(0, 3)
    tckpt.save_train_state(str(tmp_path), state)
    fresh, _, _ = _trained_state(1, 1)
    tckpt.restore_train_state(str(tmp_path), fresh)
    a, b = tckpt.snapshot(state), tckpt.snapshot(fresh)
    assert a["step"] == b["step"] == 3 and a["opt_count"] == b["opt_count"]
    assert a["optimizer"] == b["optimizer"] == "adam"
    assert torch.equal(a["generator"], b["generator"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["opt_state"]["mu"] + a["opt_state"]["nu"],
                    b["opt_state"]["mu"] + b["opt_state"]["nu"]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    idx = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    losses = [tstep.multi_train_step(s, arena, idx, idx % 2,
                                     np.ones_like(idx, bool), None,
                                     pre)["loss"] for s in (state, fresh)]
    assert torch.equal(*losses)
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)


def test_jax_snapshot_is_refused(tmp_path):
    """A checkpoint/ written by the JAX package (orbax) is refused with a
    message that says so; the model is not silently restarted."""
    cfg = jconfig.ModelConfig(**SMALL_MODEL)
    state, _ = jstate.create_train_state(cfg, jconfig.OptimConfig(),
                                         jax.random.key(0))
    ckpt_dir = str(tmp_path / "checkpoint")
    jckpt.save_train_state(ckpt_dir, state)
    template = tstate.create_train_state(
        tconfig.ModelConfig(**SMALL_MODEL), tconfig.OptimConfig(), 0, "cpu")
    with pytest.raises(ValueError, match="orbax"):
        tckpt.restore_train_state(ckpt_dir, template)

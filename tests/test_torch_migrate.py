"""The port's import of the reference's whole-module ``session_model.pth``
pickles against the JAX package's, on the CPU, with the reference's own
torch module as the third party: every case of ``tests/test_migrate.py``
through both packages. The same ``.pth`` gives a byte-identical
``session_model.msgpack``, equal summaries and ``train_config.json``, and
a forward within 2e-5 of the pickled module; a malicious pickle runs no
code; both CLIs give the same folder; and one epoch of both train CLIs on
the imported folder gives the same losses."""

import json
import os
import pickle
import zipfile

import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

from skin_image_analysis_tpu import config as jconfig
from skin_image_analysis_tpu import migrate as jmigrate
from skin_image_analysis_tpu.cli import import_reference as jimport_cli
from skin_image_analysis_tpu.cli import tone_bias_train as jtrain_cli
from skin_image_analysis_tpu.data import ingest as jingest
from skin_image_analysis_tpu.migrate import torch_pickle as jpickle
from skin_image_analysis_tpu.models.cnn import build_model as jbuild_model
from skin_image_analysis_tpu.train import loop as jloop
from skin_image_analysis_tpu_torch import bridge
from skin_image_analysis_tpu_torch import config as tconfig
from skin_image_analysis_tpu_torch import migrate as tmigrate
from skin_image_analysis_tpu_torch.cli import import_reference as timport_cli
from skin_image_analysis_tpu_torch.cli import tone_bias_train as ttrain_cli
from skin_image_analysis_tpu_torch.migrate import torch_pickle as tpickle
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.train import checkpoint as tckpt
from skin_image_analysis_tpu_torch.train import loop as tloop
from tests.fixtures import make_synthetic_dataset
from tests.test_migrate import _LegacyModel, _ListModel
from tests.test_torch_cli import _jax_one_device
from tests.test_torch_pooling import one_torch_thread  # noqa: F401


pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (model, its input side): the cases of tests/test_migrate.py
CASES = {
    "list": (lambda: _ListModel(), 32),
    "single_linear": (lambda: _ListModel(
        conv_features=(4,), first_kernel=5, linear_features=(6,),
        dropouts=(0.4,), image_size=16), 16),
    "legacy": (lambda: _LegacyModel(), 32),
    "hpo_winner": (lambda: _ListModel(
        conv_features=(8, 5, 7), first_kernel=7, kernel=3,
        linear_features=(11, 9, 6), dropouts=(0.47, 0.34, 0.27),
        image_size=32), 32),
}


def _saved(tmp_path, case: str, name: str = "session_model.pth"):
    torch.manual_seed(sorted(CASES).index(case))
    model = CASES[case][0]()
    folder = tmp_path / case
    folder.mkdir()
    torch.save(model, str(folder / name))
    return model, folder


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_matches_jax_and_the_pickled_module(tmp_path, case):
    module, folder = _saved(tmp_path, case)
    side = CASES[case][1]
    pth = str(folder / "session_model.pth")
    cfg, state_dict, names = tmigrate.import_reference_model(pth)
    jcfg, jparams, jnames = jmigrate.import_reference_model(pth)
    assert tconfig.to_dict(cfg) == jconfig.to_dict(jcfg)
    assert cfg.compute_dtype == "float32" and names == jnames
    # the same weights as JAX's tree, carried through the bridge
    want = bridge.flax_to_state_dict(jax.tree.map(np.asarray, jparams),
                                     side)
    assert state_dict.keys() == want.keys()
    for k in want:
        assert torch.equal(state_dict[k], want[k]), k

    x = np.random.default_rng(3).uniform(0, 1, (2, side, side, 3)).astype(
        np.float32)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict)
    model.eval()
    module.eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(x), train=False).numpy()
        theirs = module(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=1e-4)
    jours = np.asarray(jbuild_model(jcfg).apply(
        {"params": jparams}, jnp.asarray(x), train=False))
    np.testing.assert_allclose(ours, jours, atol=2e-5, rtol=1e-4)


def test_named_tensors_match_the_state_dict(tmp_path):
    module, folder = _saved(tmp_path, "list")
    root = tpickle.load_pth(str(folder / "session_model.pth"))
    ours = tpickle.named_tensors(root)
    theirs = jpickle.named_tensors(jpickle.load_pth(
        str(folder / "session_model.pth")))
    assert list(ours) == list(theirs) == list(module.state_dict())
    for k, v in module.state_dict().items():
        assert torch.equal(ours[k], v)
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.int64, torch.bool])
def test_storages_of_every_dtype_load(tmp_path, dtype):
    value = torch.arange(12).reshape(3, 4).to(dtype)
    holder = tnn.Module()
    holder.register_buffer("b", value.t())  # strided, not contiguous
    torch.save(holder, str(tmp_path / "h.pth"))
    got = tpickle.named_tensors(tpickle.load_pth(str(tmp_path / "h.pth")))
    assert got["b"].dtype == dtype and torch.equal(got["b"], value.t())


def test_refusals_match_jax(tmp_path):
    module, folder = _saved(tmp_path, "list")
    torch.save(module.state_dict(), str(tmp_path / "sd.pth"))
    (tmp_path / "junk.pth").write_bytes(b"not a checkpoint at all")
    bn = tnn.Sequential(tnn.Conv2d(3, 4, 3, padding="same"),
                        tnn.BatchNorm2d(4), tnn.Flatten(),
                        tnn.Linear(4 * 8 * 8, 2))
    torch.save(bn, str(tmp_path / "bn.pth"))
    for name, match in (("sd.pth", "state_dict"),
                        ("junk.pth", "zipfile"),
                        ("bn.pth", "BatchNorm|parameterized")):
        path = str(tmp_path / name)
        with pytest.raises(tmigrate.TorchPickleError, match=match):
            tmigrate.import_reference_model(path)
        with pytest.raises(jmigrate.TorchPickleError, match=match):
            jmigrate.import_reference_model(path)


def test_malicious_pickle_runs_no_code(tmp_path):
    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            import os as _os

            return (_os.system, (f"touch {marker}",))

    pth = tmp_path / "evil.pth"
    with zipfile.ZipFile(pth, "w") as zf:
        zf.writestr("archive/data.pkl", pickle.dumps(Evil()))
    root = tpickle.load_pth(str(pth))
    assert not marker.exists()
    assert getattr(type(root), "_pickle_name", "") == "system"
    with pytest.raises(tmigrate.TorchPickleError):
        tmigrate.import_reference_model(str(pth))
    with pytest.raises(tmigrate.TorchPickleError):
        tmigrate.import_reference_experiment(str(tmp_path), str(
            tmp_path / "out"), model_name="evil.pth")
    assert not marker.exists()


def test_rebuild_tensor_bounds_checked():
    storage = torch.arange(4, dtype=torch.float32)
    rebuild = tpickle._rebuild_tensor_v2
    out = rebuild(storage, 0, (2, 2), (2, 1))
    assert torch.equal(out, torch.tensor([[0.0, 1.0], [2.0, 3.0]]))
    assert torch.equal(rebuild(storage, 1, (2,), (2,)),
                       torch.tensor([1.0, 3.0]))
    for args, match in (((0, (10**6,), (1,)), "exceeds storage"),
                        ((0, (2,), (10**6,)), "exceeds storage"),
                        ((0, (2,), (-1,)), "negative"),
                        ((-1, (2,), (1,)), "negative"),
                        ((4, (), ()), "outside storage")):
        with pytest.raises(tpickle.TorchPickleError, match=match):
            rebuild(storage, *args)
    assert rebuild(storage, 0, (0, 2), (2, 1)).shape == (0, 2)
    assert rebuild(storage, 3, (), ()).item() == 3.0


def test_named_modules_shared_and_cyclic():
    class S(tpickle.Stub):
        pass

    shared = S()
    shared.__dict__["_modules"] = {}
    root = S()
    root.__dict__["_modules"] = {"a": shared, "b": shared}
    assert [n for n, _ in tpickle.named_modules(root)] == ["", "a"]
    x, y = S(), S()
    x.__dict__["_modules"] = {"y": y}
    y.__dict__["_modules"] = {"x": x}
    assert [n for n, _ in tpickle.named_modules(x)] == ["", "y"]


def _reference_folder(tmp_path, case="list"):
    module, folder = _saved(tmp_path, case)
    (folder / "session_train.csv").write_text(",isic_id\n0,ISIC_0\n")
    (folder / "session_test.csv").write_text(",isic_id\n0,ISIC_1\n")
    (folder / "2024-10-12_09-22-38.json").write_text('{"epoch": 0}\n')
    return module, folder


def _folder_bytes(folder) -> dict:
    return {n: open(os.path.join(folder, n), "rb").read()
            for n in sorted(os.listdir(folder))}


def test_import_experiment_matches_jax_byte_for_byte(tmp_path):
    _, src = _reference_folder(tmp_path)
    ours = tmigrate.import_reference_experiment(str(src), str(tmp_path / "t"))
    theirs = jmigrate.import_reference_experiment(str(src),
                                                  str(tmp_path / "j"))
    assert ours == theirs
    assert sorted(ours["copied"]) == ["2024-10-12_09-22-38.json",
                                      "session_test.csv",
                                      "session_train.csv"]
    assert _folder_bytes(tmp_path / "t") == _folder_bytes(tmp_path / "j")
    cfg, _ = tckpt.load_model(str(tmp_path / "t" / tckpt.MODEL_FILENAME))
    assert cfg.compute_dtype == "float32"


def test_both_clis_give_the_same_folder(tmp_path, capsys):
    _, src = _reference_folder(tmp_path, "legacy")
    assert timport_cli.main([str(src), str(tmp_path / "t"),
                             "--device", "cpu"]) == 0
    assert "imported ->" in capsys.readouterr().out
    assert jimport_cli.main([str(src), str(tmp_path / "j")]) == 0
    assert _folder_bytes(tmp_path / "t") == _folder_bytes(tmp_path / "j")
    # a bare .pth file works too; bad input fails cleanly in both
    pth = str(src / "session_model.pth")
    assert timport_cli.main([pth, str(tmp_path / "t2"), "--device",
                             "cpu"]) == 0
    assert _folder_bytes(tmp_path / "t2")["session_model.msgpack"] \
        == _folder_bytes(tmp_path / "j")["session_model.msgpack"]
    (tmp_path / "bad.pth").write_bytes(b"nope")
    for main, extra in ((timport_cli.main, ["--device", "cpu"]),
                        (jimport_cli.main, [])):
        assert main([str(tmp_path / "bad.pth"), str(tmp_path / "o"),
                     *extra]) == 1
        assert main([str(src)]) == 1
    assert timport_cli.main([str(src), str(tmp_path / "o"), "--bogus"]) == 1


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A 32² cohort, a reference folder over it (a dropout-free
    _ListModel and split CSVs in pandas' layout) and its import by each
    package's CLI."""
    tmp = tmp_path_factory.mktemp("imported")
    root = str(tmp / "cohort")
    make_synthetic_dataset(root, n=72, seed=11, image_size=32)
    src = tmp / "ref"
    src.mkdir()
    torch.manual_seed(5)
    torch.save(_ListModel(dropouts=(0.0, 0.0)), str(src / "session_model.pth"))
    df = jingest.balance_dataset(jingest.read_isic_metadata(root, seed=0),
                                 seed=0, verbose=False)
    train_df, test_df = jingest.shuffle_split(df, seed=0)
    train_df.to_csv(src / "session_train.csv")
    test_df.to_csv(src / "session_test.csv")
    assert timport_cli.main([str(src), str(tmp / "port"), "--device",
                             "cpu"]) == 0
    assert jimport_cli.main([str(src), str(tmp / "jax")]) == 0
    return dict(root=root, tmp=tmp, port=str(tmp / "port"),
                jax=str(tmp / "jax"))


def test_train_clis_continue_the_imported_folder_alike(imported,
                                                       monkeypatch):
    """One epoch of each package's train CLI on its imported folder (no
    augment, dropout 0, float32 from the import): the same per-step
    losses, to the flagship tests' rtol 1e-4."""
    monkeypatch.chdir(imported["tmp"])
    args = ["--batch-size", "4", "--steps-per-dispatch", "2",
            "--image-size", "32"]
    jax_losses, port_losses = [], []
    with _jax_one_device() as mp:
        make_multi = jloop.make_multi_train_step

        def recording_multi(*a, **kw):
            multi = make_multi(*a, **kw)

            def call(*args):
                state, m = multi(*args)
                m = jax.device_get(m)
                if m["count"].any():  # not the inert warm-up call
                    jax_losses.append(np.asarray(m["loss"]))
                return state, m
            return call

        mp.setattr(jloop, "make_multi_train_step", recording_multi)
        assert jtrain_cli.main([imported["root"], "1", imported["jax"],
                                *args]) == 0
        multi_step = tloop.multi_train_step

        def recording_step(*a, **kw):
            m = multi_step(*a, **kw)
            port_losses.append(m["loss"].numpy())
            return m

        mp.setattr(tloop, "multi_train_step", recording_step)
        assert ttrain_cli.main([imported["root"], "1", imported["port"],
                                *args, "--device", "cpu"]) == 0
    assert len(port_losses) == len(jax_losses)
    assert len(np.concatenate(port_losses)) > 1
    for got, want in zip(port_losses, jax_losses):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    assert np.isfinite(np.concatenate(port_losses)).all()
    for folder in (imported["port"], imported["jax"]):
        assert tloop.completed_epochs(folder) == 1
        names = os.listdir(folder)
        assert any(n.endswith(".json") and n[0].isdigit() for n in names)
    n_test = len(pd.read_csv(os.path.join(imported["port"],
                                          "session_test.csv")))
    rec = [json.loads(line) for n in sorted(os.listdir(imported["port"]))
           if n.endswith(".json") and n[0].isdigit()
           for line in open(os.path.join(imported["port"], n))]
    assert rec[-1]["total"] == n_test

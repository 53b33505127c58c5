"""The port's transfer CLIs (``tone_classifier_train``, ``ham_train``)
against the JAX package's, on the CPU: the same printed lines and
experiment folder from the same arguments, every Keras-compatible
family through both, and the tone labels of ``ToneTable``."""

import ast
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from skin_image_analysis_tpu.cli import ham_train as jham_cli
from skin_image_analysis_tpu.cli import tone_classifier_train as jtone_cli
from skin_image_analysis_tpu.toneclassifier.trainer import (
    ToneTable as JToneTable,
)
from skin_image_analysis_tpu_torch.cli import ham_train as tham_cli
from skin_image_analysis_tpu_torch.cli import tone_classifier_train as ttone_cli
from skin_image_analysis_tpu_torch.data.ingest import read_csv
from skin_image_analysis_tpu_torch.toneclassifier.trainer import ToneTable
from tests.test_torch_classify import write_ham_root
from tests.test_torch_families import one_torch_thread  # noqa: F401
from tests.test_torch_native_loader import same_decoders

SMALL = ["--image-size", "32", "--canonical-size", "40", "--batch-size",
         "8", "--steps-per-dispatch", "2"]
# the port's runs train resnet18; the JAX CLIs' lines and folders, the form
# they are held to, come from the flagship model, which the JAX package
# compiles in a fraction of a ResNet's time on the CPU (its lines and
# files do not depend on the model)
MODELS = {"jax": ["--model", "skin_cancer_list"],
          "port": ["--model", "resnet18"]}


@pytest.fixture(scope="module")
def ham_root(tmp_path_factory):
    return write_ham_root(tmp_path_factory.mktemp("hamcli"))


def _form(text: str, out_dir: str) -> list[tuple]:
    """Each printed line as (label, the keys of its dict or its text with
    the out dir cut out)."""
    form = []
    for line in text.strip().splitlines():
        label, _, rest = line.partition(": ")
        if rest.startswith("{"):
            form.append((label, sorted(ast.literal_eval(rest))))
        else:
            form.append((label, rest.replace(out_dir, "<out>")))
    return form


def _both(jmain, tmain, argv, tmp_path, capsys, monkeypatch):
    same_decoders(monkeypatch)
    outs = {}
    for name, main, extra in (("jax", jmain, []),
                              ("port", tmain, ["--device", "cpu"])):
        out = str(tmp_path / name)
        assert main([*argv, *MODELS[name], "--out", out, *extra]) == 0
        outs[name] = (_form(capsys.readouterr().out, out),
                      sorted(os.listdir(out)))
    return outs


def test_tone_classifier_cli_matches_jax(synth_root, tmp_path, capsys,
                                         monkeypatch):
    """The port's run (resnet18) prints the JAX CLI's lines, with the same
    keys, and keeps the same files."""
    outs = _both(jtone_cli.main, ttone_cli.main, [synth_root, "1", *SMALL],
                 tmp_path, capsys, monkeypatch)
    assert outs["port"] == outs["jax"]
    form, files = outs["port"]
    assert [label for label, _ in form] == [
        "epoch 0", "final test metrics", "metrics log", "model artifact"]
    assert {"session_model.msgpack", "metrics.jsonl",
            "train_config.json"} <= set(files)


def test_ham_cli_dx_matches_jax(ham_root, tmp_path, capsys, monkeypatch):
    csv_path = os.path.join(ham_root, "HAM10000_metadata.csv")
    outs = _both(jham_cli.main, tham_cli.main,
                 [ham_root, csv_path, "1", "--classes", "dx", *SMALL,
                  "--keep-best", "f1"], tmp_path, capsys, monkeypatch)
    assert outs["port"] == outs["jax"]
    form, files = outs["port"]
    assert [label for label, _ in form] == [
        "epoch 0", "final test metrics", "model artifact"]
    assert "auc" not in form[1][1]  # 7 classes
    assert "session_model_best.msgpack" in files


def test_ham_cli_default_model_matches_jax(ham_root, tmp_path, capsys,
                                          monkeypatch):
    """``ham_train`` with its default model (xception at full depth, here
    at 32²) and classes (binary): the JAX CLI's lines and files, and a
    ``session_model.msgpack`` that names xception."""
    from skin_image_analysis_tpu_torch.train import checkpoint as tckpt

    monkeypatch.setitem(MODELS, "port", [])
    csv_path = os.path.join(ham_root, "HAM10000_metadata.csv")
    outs = _both(jham_cli.main, tham_cli.main,
                 [ham_root, csv_path, "1", *SMALL], tmp_path, capsys,
                 monkeypatch)
    assert outs["port"] == outs["jax"]
    form, _ = outs["port"]
    assert "auc" in form[1][1]  # 2 classes
    cfg, sd = tckpt.load_model(str(tmp_path / "port" /
                                   "session_model.msgpack"))
    assert cfg.name == "xception" and "block12_sepconv3.depthwise.weight" \
        in sd


def test_tone_classifier_cli_ita_matches_jax(synth_root, tmp_path, capsys,
                                             monkeypatch):
    """``--input ita``: the JAX CLI's lines and files; a 2-channel model
    and no ImageNet normalization in ``train_config.json``."""
    import json

    outs = _both(jtone_cli.main, ttone_cli.main,
                 [synth_root, "1", *SMALL, "--input", "ita"], tmp_path,
                 capsys, monkeypatch)
    assert outs["port"] == outs["jax"]
    with open(tmp_path / "port" / "train_config.json") as f:
        written = json.load(f)
    assert written["data"] == {"normalize_imagenet": False}
    assert written["classify"]["input_mode"] == "ita"


def test_tone_table_matches_jax(synth_root, tmp_path):
    """Fitzpatrick I/II light, III-VI dark; rows without a type or without
    ``<isic_id>.jpg`` dropped."""
    root = str(tmp_path / "tone")
    shutil.copytree(synth_root, root)
    for i in (0, 4, 9):
        os.remove(os.path.join(root, f"ISIC_{i:07d}.jpg"))
    path = os.path.join(root, "metadata.csv")
    mine = ToneTable(read_csv(path), root)
    theirs = JToneTable(pd.read_csv(path), root)
    assert mine.metadata.column("isic_id") == \
        theirs.metadata_df["isic_id"].tolist()
    np.testing.assert_array_equal(mine.labels, theirs.labels)
    assert mine.class_names == theirs.class_names == ("light", "dark")
    assert "ISIC_0000004" not in mine.metadata.column("isic_id")


_JAX_FORMS: dict[str, tuple] = {}


def _jax_form(which, argv, tmp_path, capsys, monkeypatch):
    """The JAX CLI's printed form and files for ``argv`` (its flagship
    model), run once a CLI."""
    if which not in _JAX_FORMS:
        same_decoders(monkeypatch)
        main = jtone_cli.main if which == "tone" else jham_cli.main
        out = str(tmp_path / "jax")
        assert main([*argv, *MODELS["jax"], "--out", out]) == 0
        _JAX_FORMS[which] = (_form(capsys.readouterr().out, out),
                             sorted(os.listdir(out)))
    return _JAX_FORMS[which]


@pytest.mark.parametrize("which,model", [
    ("tone", "mobilenet_v2"),
    ("tone", "resnet50_v2"),
    ("tone", "efficientnet_b0"),
    ("ham", "vgg16"),
    ("ham", "efficientnet_v2_s"),
])
def test_transfer_clis_train_every_keras_family(which, model, synth_root,
                                                ham_root, tmp_path, capsys,
                                                monkeypatch,
                                                one_torch_thread):
    """Each Keras-compatible family at full depth (here at 32²): the JAX
    CLI's lines, with the same keys, and the same files; a
    ``session_model.msgpack`` that names the family."""
    from skin_image_analysis_tpu_torch.train import checkpoint as tckpt

    if which == "tone":
        main, argv = ttone_cli.main, [synth_root, "1", *SMALL]
    else:
        main, argv = tham_cli.main, [
            ham_root, os.path.join(ham_root, "HAM10000_metadata.csv"), "1",
            *SMALL]
    want = _jax_form(which, argv, tmp_path, capsys, monkeypatch)
    out = str(tmp_path / "port")
    assert main([*argv, "--model", model, "--out", out, "--device",
                 "cpu"]) == 0
    assert (_form(capsys.readouterr().out, out),
            sorted(os.listdir(out))) == want
    cfg, _ = tckpt.load_model(os.path.join(out, "session_model.msgpack"))
    assert cfg.name == model


def test_transfer_clis_need_a_card_unless_asked_for_the_cpu(
        synth_root, ham_root, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttone_cli.main([synth_root, "1", *SMALL, *MODELS["port"], "--out",
                        str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tham_cli.main([ham_root, os.path.join(ham_root,
                                              "HAM10000_metadata.csv"),
                       "1", *SMALL, *MODELS["port"], "--out",
                       str(tmp_path)])
    assert ttone_cli.main([synth_root]) == 1  # usage
    assert "Usage" in capsys.readouterr().out

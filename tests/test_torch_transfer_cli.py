"""The port's transfer CLIs (``tone_classifier_train``, ``ham_train``)
against the JAX package's, on the CPU: the same printed lines and
experiment folder from the same arguments, the tone labels of
``ToneTable``, and the refusals of what is not ported yet."""

import ast
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from skin_image_analysis_tpu.cli import ham_train as jham_cli
from skin_image_analysis_tpu.cli import tone_classifier_train as jtone_cli
from skin_image_analysis_tpu.data import native_loader
from skin_image_analysis_tpu.toneclassifier.trainer import (
    ToneTable as JToneTable,
)
from skin_image_analysis_tpu_torch.cli import ham_train as tham_cli
from skin_image_analysis_tpu_torch.cli import tone_classifier_train as ttone_cli
from skin_image_analysis_tpu_torch.data.ingest import read_csv
from skin_image_analysis_tpu_torch.toneclassifier.trainer import ToneTable
from tests.test_torch_classify import write_ham_root

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


def _no_native(*a, **k):
    raise RuntimeError("the port has no libjpeg decoder")


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
    monkeypatch.setattr(native_loader, "decode_batch_into", _no_native)
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


@pytest.mark.parametrize("which,argv,match", [
    ("tone", ["--model", "mobilenet_v2"], "'mobilenet_v2'.*item 7b"),
    ("tone", ["--model", "resnet50_v2"], "'resnet50_v2'.*item 7b"),
    ("tone", ["--model", "efficientnet_b0"], "item 7b"),
    ("ham", ["--model", "vgg16"], "'vgg16'.*item 7b"),
    ("ham", ["--model", "efficientnet_v2_s"], "'efficientnet_v2_s'.*item 7b"),
])
def test_transfer_clis_refuse_the_unported_by_name(which, argv, match,
                                                   synth_root, ham_root,
                                                   tmp_path):
    if which == "tone":
        main, pos = ttone_cli.main, [synth_root, "1"]
    else:
        main, pos = tham_cli.main, [
            ham_root, os.path.join(ham_root, "HAM10000_metadata.csv"), "1"]
    with pytest.raises(NotImplementedError, match=match):
        main([*pos, *argv, "--out", str(tmp_path / "x"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "x")


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

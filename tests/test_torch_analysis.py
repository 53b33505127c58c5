"""The port's experiment analysis (``analysis/`` and the analysis CLI)
against the JAX package's on the CPU, on experiment folders written here:
the flattened records, ``global_epoch`` across a resumed run's files, the
aggregate means and confidence intervals (scipy's t quantile, and the
table without scipy), and the figures."""

import json
import math
import os
import sys

import pytest

from skin_image_analysis_tpu import analysis as janalysis
from skin_image_analysis_tpu.analysis import experiments as jexperiments
from skin_image_analysis_tpu.cli import tone_bias_analysis as jcli
from skin_image_analysis_tpu_torch import analysis as tanalysis
from skin_image_analysis_tpu_torch.analysis import experiments as texperiments
from skin_image_analysis_tpu_torch.analysis import plots as tplots
from skin_image_analysis_tpu_torch.cli import tone_bias_analysis as tcli
from skin_image_analysis_tpu_torch.metrics.fairness import di_from_counts


def _record(epoch, di, loss, acc):
    tone = di_from_counts(2, 3, 1, 1, 4, 4, 2, 0)
    tone["di"] = di
    return {
        "correct": 10, "total": 20, "accuracy": acc,
        "tone_di_results": tone,
        "gender_di_results": di_from_counts(1, 2, 1, 1, 3, 1, 1, 1),
        "control_di_results": di_from_counts(1, 1, 1, 1, 1, 1, 1, 1),
        "avg_batch_loss": loss, "train_accuracy": 0.6, "epoch": epoch,
        "auc": float("nan") if epoch == 1 else 0.5 + 0.1 * epoch,
    }


def write_runs(base, prefix="balanced", runs=3, files=2, epochs=2):
    """``runs`` experiment folders under ``base``, each a resumed run of
    ``files`` timestamped record files of ``epochs`` lines (the last run
    one file short), plus a config file and a truncated last line."""
    for r in range(runs):
        folder = os.path.join(base, f"{prefix}_2026-01-0{r + 1}_00-00-00")
        os.makedirs(folder)
        with open(os.path.join(folder, "train_config.json"), "w") as f:
            json.dump({"data": {}}, f)
        for i in range(files - (r == runs - 1)):
            path = os.path.join(folder, f"2026-01-0{i + 1}_00-00-00.json")
            with open(path, "w") as f:
                for e in range(epochs):
                    f.write(json.dumps(_record(
                        e, 0.8 + 0.05 * r + 0.01 * i, 0.7 - 0.1 * e,
                        0.6 + 0.02 * r)) + "\n")
                if i == 0:
                    f.write('{"truncated": ')
    os.makedirs(os.path.join(base, "imbalanced_x"))


def _same(a, b):
    """Equal, with NaN equal to NaN, through dicts, lists and tuples."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def test_read_experiment_matches_jax(tmp_path):
    write_runs(str(tmp_path))
    for name in sorted(os.listdir(tmp_path)):
        folder = str(tmp_path / name)
        got = tanalysis.read_experiment(folder)
        assert _same(got, janalysis.read_experiment(folder))
    first = tanalysis.read_experiment(
        str(tmp_path / "balanced_2026-01-01_00-00-00"))
    assert [r["global_epoch"] for r in first] == [0, 1, 2, 3]
    assert first[0]["tone_di"] == 0.8 and "tone_di_results" not in first[0]


def test_read_experiments_matches_jax(tmp_path):
    write_runs(str(tmp_path))
    got = tanalysis.read_experiments(str(tmp_path), "balanced")
    assert _same(got, janalysis.read_experiments(str(tmp_path),
                                                 "balanced"))
    assert got["n_runs"] == 3 and got["epochs"] == [0, 1, 2, 3]
    assert tanalysis.read_experiments(str(tmp_path), "imbalanced") == \
        janalysis.read_experiments(str(tmp_path), "imbalanced")


@pytest.mark.parametrize("scipy", [True, False])
@pytest.mark.parametrize("n", [1, 2, 5, 12, 31])
def test_compute_ci_matches_jax(n, scipy, monkeypatch):
    """Equal to JAX's to 1e-12, with scipy's t quantile and with the
    table both packages fall back on without scipy."""
    if not scipy:
        monkeypatch.setitem(sys.modules, "scipy", None)
    data = [math.sin(i) + 0.1 * i for i in range(n)]
    for level in (0.90, 0.95):
        got = tanalysis.compute_ci(data, level)
        assert got == pytest.approx(janalysis.compute_ci(data, level),
                                    abs=1e-12)
    assert texperiments._t_critical(3, 0.90) == pytest.approx(
        jexperiments._t_critical(3, 0.90), abs=1e-12)


def test_flatten_and_transpose_match_jax():
    rec = _record(3, 1.1, 0.2, 0.7)
    assert _same(tanalysis.flatten_record(rec),
                 janalysis.flatten_record(rec))
    recs = [{"a": 1, "b": 2}, {"a": 3}]
    assert tanalysis.transpose_dict(recs) == janalysis.transpose_dict(recs)


def test_plots_write_figures_and_name_matplotlib_when_missing(tmp_path,
                                                              monkeypatch):
    write_runs(str(tmp_path))
    agg = tanalysis.read_experiments(str(tmp_path), "balanced")
    di = tplots.plot_di_figure(agg, "balanced", save_dir=str(tmp_path))
    acc = tplots.plot_accuracy_figure(agg, "balanced",
                                      save_dir=str(tmp_path))
    assert di == str(tmp_path / "figure_balanced.png")
    assert acc == str(tmp_path / "figure_balanced_accuracy.png")
    assert os.path.getsize(di) > 0 and os.path.getsize(acc) > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tplots.plot_di_figure(agg, "balanced", save_dir=str(tmp_path))


@pytest.mark.parametrize("argv", [["balanced", "1"], ["balanced", "9"],
                                  ["imbalanced", "0"], ["nothing", "0"],
                                  ["balanced"]])
def test_analysis_cli_prints_what_jax_prints(argv, tmp_path, capsys):
    """The same exit code and lines (the figures' paths aside, which name
    each package's own directory)."""
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        base = str(tmp_path / name)
        os.makedirs(base)
        write_runs(base)
        code = main([*argv, "--experiments-dir", base])
        text = capsys.readouterr().out.replace(base, "<dir>")
        outs[name] = (code, text)
        if code == 0:
            assert sorted(n for n in os.listdir(base)
                          if n.endswith(".png")) == [
                f"figure_{argv[0]}.png", f"figure_{argv[0]}_accuracy.png"]
    assert outs["port"] == outs["jax"]

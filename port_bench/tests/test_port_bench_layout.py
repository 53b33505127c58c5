"""The benchmark's files: every piece loads and is found by its name, the
contract's limits on names, units and sizes hold, and the frozen
arithmetic gives the numbers it was copied for."""

from __future__ import annotations

import importlib
import json
import re
import shutil

import pytest

from port_bench import bounds, flops, peaks
from port_bench.reference import flagship
from port_bench.run import load_json, load_spec
from port_bench.tests.tiny import ROOT

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert (ROOT / path).is_dir()
    # a full check of 24 cells fits the driver's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_are_unique_and_every_config_is_used():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_loads(cell):
    spec = load_spec(ROOT, cell)
    assert spec["workload"]["name"] == cell
    importlib.import_module(
        f"port_bench.drivers.{spec['workload']['driver']}").Driver
    for m in spec["end_to_end"] + spec["per_layer"]:
        reader = importlib.import_module(f"port_bench.metrics.{m['name']}")
        assert callable(reader.read)
    assert spec["traffic"]["rows"] == sum(spec["traffic"]["counts"])
    model, program = spec["config"]["model"], spec["config"]["program"]
    num_classes = (program["classify"]["num_classes"]
                   if "classify" in program
                   else program["model"]["num_classes"])
    assert model["num_classes"] == num_classes
    assert model["num_classes"] == len(spec["traffic"]["classes"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    spec = load_spec(ROOT, cell)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
    assert set(spec["workload"]["checks"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_one_layer_name_per_layer_and_every_metric_has_a_reader():
    for m in METRICS:
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_a_new_cell_is_found_from_its_files_alone(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = load_spec(ROOT, CELLS[0])
    new = dict(bench["workloads"][0], name="flagship-isic-train-copy",
               traffic="isic2020_copy")
    bench["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "port_bench" / "traffic" / "isic2020_copy.json").write_text(
        json.dumps(base["traffic"]))
    (tmp_path / "port_bench" / "workloads"
     / "flagship-isic-train-copy.json").write_text(
        json.dumps(dict(base["workload"], name=new["name"])))
    spec = load_spec(tmp_path, new["name"])
    assert spec["traffic"] == base["traffic"]
    assert [m["name"] for m in spec["end_to_end"]] == ["setup_s"]
    assert spec["per_layer"] == []


def test_flagship_forward_flops_match_the_bench_arithmetic():
    cfg = load_spec(ROOT, "flagship-isic-train")["config"]["model"]
    assert flagship.forward_flops_per_image(cfg) == 1_499_923_456
    assert flops.per_image(flagship, cfg, 2, train=False) == 1_499_923_456


def test_train_flops_leave_out_the_input_gradient_and_a_frozen_backbone():
    from port_bench.reference import resnet

    cfg = load_spec(ROOT, "flagship-isic-train")["config"]["model"]
    fwd = flagship.forward_flops_per_image(cfg)
    conv0 = 2 * 224 * 224 * 32 * 7 * 7 * 3
    assert flops.per_image(flagship, cfg, 2, train=True) == 3 * fwd - conv0
    whole = load_spec(ROOT, "resnet50-ham-finetune")["config"]["model"]
    frozen = load_spec(ROOT, "resnet50-ham-frozen")["config"]["model"]
    head = 2 * 2048 * 7          # the head's weight gradient alone
    assert flops.per_image(resnet, frozen, 2, train=True) == \
        flops.per_image(resnet, whole, 2, train=False) + head


def test_preprocess_bound_is_the_kernels_published_bound():
    h100 = peaks.for_device("NVIDIA H100 80GB HBM3")
    bound = bounds.preprocess_bound_s(256, 3, 224, 2, rows=True, tail=True,
                                      peaks=h100)
    assert round(bound * 1e3, 4) == 0.0345
    # the transfer call (no tail, float32 out, B=32): 0.00719 ms
    bound = bounds.preprocess_bound_s(32, 3, 224, 4, rows=True, tail=False,
                                      peaks=h100)
    assert round(bound * 1e3, 5) == 0.00719

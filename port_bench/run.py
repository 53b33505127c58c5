"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python3 -m port_bench.run ...``) from the root of a checkout that
holds ``BENCHMARK.json``, ``port_bench/`` and the port
``skin_image_analysis_tpu_torch/``. It needs a CUDA device: without one
(or with fewer than the cell asks for) it exits 2 and prints no result.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its files are
found by name: ``port_bench/configs/<config>.json``,
``port_bench/traffic/<traffic>.json``, ``port_bench/workloads/<cell>.json``
(the driver, ``port_bench/drivers/<driver>.py``, and the limits of the
comparison) and one ``port_bench/metrics/<metric>.py`` per metric.

Set-up makes the cohort and weights from the seed, builds the train
state, audits once and runs the first three train steps (the readings
the comparison judges); ``setup_s`` ends at the window's first step. The
window then runs whole epochs of the program's loop, each with its
audit, until ``--seconds`` have passed. ``--trace 1`` profiles one more
epoch after the window. Then the program's state is freed, the plain
reference runs, and every compared number is printed beside its limit,
on standard error and as the result line's last key. The last line of
standard output is the result: ``correct``, ``attempted`` and ``failed``
(the window's live train steps and those with a non-finite loss),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``. Builds and caches
stay inside the checkout's ``build/``; torch's CPU work runs on one
thread. If JAX, Flax, optax or the JAX
package is loaded once the window has closed, the run exits 3 without a
result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "skin_image_analysis_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path, workload: str) -> dict:
    """The cell ``workload``: its ``BENCHMARK.json`` entry, its config,
    traffic and workload files, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = root / "port_bench"

    def reported(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return {
        "entry": entry,
        "config": load_json(root / config["file"]),
        "traffic": load_json(here / "traffic" / f"{entry['traffic']}.json"),
        "workload": load_json(here / "workloads" / f"{workload}.json"),
        "end_to_end": reported(bench["end_to_end"]),
        "per_layer": reported(bench["per_layer"]),
    }


def forbidden_modules() -> list[str]:
    """Loaded top-level modules of JAX, Flax, optax or the JAX package,
    compared by their whole top-level name."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def power_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0, log=sys.stderr) -> dict:
    """One run of the cell ``spec`` (``load_spec``) on ``device``: the
    result line's dict."""
    import torch

    from port_bench import bounds, checks, flops, peaks
    from port_bench.reference.precision import EXACT
    from port_bench.trace import profile_epoch

    driver = importlib.import_module(
        f"port_bench.drivers.{spec['workload']['driver']}")
    cell = driver.Driver(spec, seed, device)
    cell.setup()
    _sync(cell.device)
    setup_s = time.perf_counter() - t0
    cell.spans.seconds.clear()
    cell.spans.counts.clear()

    images = steps = bad = epochs = 0
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        done = cell.epoch()
        images, steps, bad = (images + done.images, steps + done.steps,
                              bad + done.bad_steps)
        epochs += 1
        print(f"epoch {epochs}: {time.perf_counter() - t:.4f} s, "
              f"{done.images} images", file=log)
        if time.perf_counter() - start >= seconds:
            break
    elapsed = time.perf_counter() - start
    loaded = forbidden_modules()
    if loaded:
        raise ForbiddenImport(loaded)

    on_card = cell.device.type == "cuda"
    kind = torch.cuda.get_device_name(cell.device) if on_card else "cpu"
    memory_peak = (torch.cuda.max_memory_allocated(cell.device) if on_card
                   else 0)
    cfg = cell.model_cfg
    run = SimpleNamespace(
        setup_s=setup_s, elapsed_s=elapsed, images=images, steps=steps,
        audits=epochs, audit_rows=cell.cohort.test_arena.shape[0],
        span_s=dict(cell.spans.seconds), span_n=dict(cell.spans.counts),
        traced=None, flops=None, peaks=peaks.for_device(kind),
        preprocess_bound_s=None)
    breakdown = None
    if trace:
        t = time.perf_counter()
        run.traced, _ = profile_epoch(cell)
        print(f"traced epoch and its reduction: "
              f"{time.perf_counter() - t:.3f} s", file=log)
        run.flops = {
            "train": flops.per_image(cell.reference, cfg, cell.batch, True),
            "eval": flops.per_image(cell.reference, cfg, cell.batch, False)}
        if run.peaks is not None:
            aug = spec["config"]["augment"]
            run.preprocess_bound_s = bounds.preprocess_bound_s(
                cell.batch, cfg["in_channels"], cfg["image_size"],
                torch.finfo(getattr(torch, cfg["preprocess_dtype"])).bits
                // 8, rows=True,
                tail=any(aug[k] > 0 for k in ("brightness", "contrast",
                                              "saturation")),
                peaks=run.peaks)
        if run.traced is not None:
            t = run.traced
            breakdown = {"device_ops": t.device_ops,
                         "idle_gaps": t.idle_gaps}
            print(f"traced epoch: {t.window_s:.6f} s, device busy "
                  f"{t.busy_s:.6f} s, kernels by span {t.kernels}, "
                  f"device s by span {t.device_s}, calls {t.calls}, "
                  f"steps {t.steps}, device operations {t.operations}, "
                  f"kernels tied to a launch {t.launches}", file=log)
            print("device s by kernel group: " + json.dumps(t.groups),
                  file=log)
    print(f"card: {power_line() if on_card else 'cpu'}", file=log)

    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = importlib.import_module(
            f"port_bench.metrics.{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    program = cell.program
    cell.release()
    want = checks.reference_readings(cell, EXACT)
    values = checks.numbers(cell, program, want)
    limits = spec["workload"]["checks"]
    correct = checks.judge(values, limits) and bad == 0
    for name, value in values.items():
        if name not in limits:
            print(f"reading {name}: {value!r} (not compared)", file=log)
    print(f"run: {time.perf_counter() - t0:.3f} s", file=log)
    for name in limits:
        print(f"check {name}: {values.get(name)!r} (limit {limits[name]!r})",
              file=log)
    loaded = forbidden_modules()
    if loaded:
        raise ForbiddenImport(loaded)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace and run.traced is not None:
        device_info["busy_s"] = run.traced.busy_s
        device_info["window_s"] = run.traced.window_s
    result = {"correct": bool(correct), "attempted": steps, "failed": bad,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {
        k: {"value": _number(values.get(k, math.nan)), "limit": lim}
        for k, lim in limits.items()}
    return result


def _number(v: float):
    """A JSON value for ``v``: the number, or its name when not finite."""
    return v if math.isfinite(v) else str(v)


class ForbiddenImport(RuntimeError):
    def __init__(self, names: list[str]):
        super().__init__(", ".join(names))
        self.names = names


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_spec(ROOT, args.workload)
    cache = ROOT / "build" / "port_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # one host thread for torch's CPU work: the loops are host-bound in
    # part, and a pool of threads spreads the runs' rates three times wider
    os.environ["OMP_NUM_THREADS"] = "1"

    import torch

    torch.set_num_threads(1)

    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result = run_cell(spec, args.seed % 2**63, args.seconds,
                          bool(args.trace))
    except ForbiddenImport as e:
        print(f"port_bench: loaded in the benchmark's process: {e}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

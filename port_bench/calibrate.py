"""The readings the comparison's limits are set from, for one cell.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3]

For each seed, in one process: the cell's set-up (the program's first
audit and first three train steps, at the cell's own sizes), then the
plain reference, and one JSON line of every compared number of the
program. For each control seed also the numbers of two stand-ins put in
the program's place: the control (the reference one precision step
below the configuration, ``reference.precision.control``) and the
reference with a planted fault (each step's loss over half of its rows).
A state left unchanged reads 1 on ``grad_gap`` and ``update_gap`` by
their definition and needs no run. No window runs: training's readings
need none.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def worst_leaves(got: dict, want: dict, n: int = 3) -> list:
    """The ``n`` leaves with the largest gaps of norms, for diagnosis."""
    moving = [v for v in want.values() if v > 0]
    med = statistics.median(moving) if moving else 1.0
    gaps = sorted(((abs(got.get(k, 0.0) - v) / max(v, med), k, v)
                   for k, v in want.items()), reverse=True)
    return [[k, g, v] for g, k, v in gaps[:n]]


def readings(spec: dict, seed: int, control: bool, device: str = "cuda"):
    import importlib

    import torch

    from port_bench import checks
    from port_bench.reference import precision

    driver = importlib.import_module(
        f"port_bench.drivers.{spec['workload']['driver']}")
    start = time.perf_counter()
    cell = driver.Driver(spec, seed, device)
    cell.setup()
    program = cell.program
    cell.release()
    setup = time.perf_counter() - start
    want = checks.reference_readings(cell, precision.EXACT)
    line = {"seed": seed, "setup_s": setup,
            "program": checks.numbers(cell, program, want),
            "losses": [program.losses, want.losses],
            "worst_grad": worst_leaves(program.grad_norms, want.grad_norms),
            "worst_update": worst_leaves(program.delta_norms,
                                         want.delta_norms)}
    if control:
        stand_ins = {
            "control": checks.reference_readings(
                cell, precision.control(cell.model_cfg["preprocess_dtype"])),
            "half_batch": checks.reference_readings(cell, precision.EXACT,
                                                    half_batch=True)}
        for name, got in stand_ins.items():
            got = got._replace(record=checks.audit_record_of(
                cell, got.log_probs))
            line[name] = checks.numbers(cell, got, want)
    line["seconds"] = time.perf_counter() - start
    del cell
    if device == "cuda":
        torch.cuda.empty_cache()
    return line


def main(argv: list[str] | None = None) -> int:
    from port_bench.run import load_spec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    spec = load_spec(ROOT, args.workload)
    for seed in args.seeds:
        line = readings(spec, seed, seed in args.control_seeds)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The program's own spans in the benchmark's traced epoch, and the six
per-layer numbers that read them.

The port marks its layers with ``utils.profiling.annotate``: under a
profiler, ``record_function`` ranges named ``sia.<name>``
(``train.call``, ``train.step`` with ``train.preprocess``,
``train.forward``, ``train.backward``, ``train.optimizer``;
``eval.call``, ``audit.fetch``, ``audit.record``). :func:`reduce_program`
gives each span its calls, host seconds, the device kernels and device
seconds launched inside its ranges (``port_bench.trace``'s rule: a
device operation's launch is its CUDA call, else its operator, whatever
the thread) and the idle seconds of the gaps whose midpoint lies inside
it. It names each idle gap of the epoch by the innermost program span
at its midpoint, else by the harness's span as ``trace.reduce`` does.

The benchmark's result line does not carry these numbers:
``trace.reduce`` keeps no raw events for a metric's reader. This module
runs the benchmark's own traced epoch once and prints them:

    python3 -m port_bench.program_spans --workload <cell> --seed <n>

set-up as a run's, one epoch, then ``trace.profile_epoch``'s epoch. The
last line of standard output is a JSON object: ``metrics`` (the six
numbers), ``spans`` (the table), ``idle_gaps`` (ten ``[name, seconds]``
as the breakdown's), ``kernels_per_step`` as the benchmark reads it, and
the harness's ``preprocess`` span beside the program's
``train.preprocess``. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import trace  # noqa: E402
from port_bench.spans import PREFIX as HARNESS  # noqa: E402

#: the prefix of the program's spans (``utils.profiling.SPAN_PREFIX``)
PROGRAM = "sia."

#: metric -> (program span, field, divided by): ``step`` is the count of
#: ``train.step`` ranges, ``audit`` the count of the harness's ``audit``
METRICS = {
    "forward_device_ms": ("train.forward", "device_s", "step"),
    "backward_device_ms": ("train.backward", "device_s", "step"),
    "optimizer_device_ms": ("train.optimizer", "device_s", "step"),
    "step_idle_ms": ("train.call", "idle_s", "step"),
    "audit_device_ms": ("eval.call", "device_s", "audit"),
    "audit_record_ms": ("audit.record", "host_s", "audit"),
}


def _holding(t: float, ranges: list):
    """The one of the sorted ``ranges`` of one span that holds ``t``, or
    None (a span's ranges do not overlap)."""
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
        return ranges[i]
    return None


def reduce_program(events) -> dict | None:
    """``{"spans": {span: {calls, host_s, kernels, device_s, idle_s}},
    "idle_gaps": [[name, seconds]] * 10, "audits": n}`` of a profile's raw
    events (``kineto_results.events()``); None without the harness's
    epoch spans. The device's copies of the ranges of either prefix are
    no device operations."""
    cpu = torch.autograd.DeviceType.CPU
    harness: dict[str, list] = defaultdict(list)
    spans: dict[str, list] = defaultdict(list)
    api, ops = {}, {}             # correlation id -> host start ns
    device = []                   # (start ns, end ns, corr, linked)
    for e in events:
        name = e.name()
        ranged = name.startswith(HARNESS) or name.startswith(PROGRAM)
        if e.device_type() == cpu:
            if name.startswith(HARNESS):
                harness[name[len(HARNESS):]].append((e.start_ns(),
                                                     e.end_ns()))
            elif name.startswith(PROGRAM):
                spans[name[len(PROGRAM):]].append((e.start_ns(),
                                                   e.end_ns()))
            elif name.startswith("cu"):
                api[e.correlation_id()] = e.start_ns()
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = e.start_ns()
        elif not ranged and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.correlation_id(),
                           e.linked_correlation_id()))
    if not all(harness.get(s) for s in trace.EPOCH_SPANS):
        return None
    for rs in (*harness.values(), *spans.values()):
        rs.sort()
    table = {s: {"calls": len(rs),
                 "host_s": sum(b - a for a, b in rs) / 1e9,
                 "kernels": 0, "device_s": 0.0, "idle_s": 0.0}
             for s, rs in spans.items()}
    for a, b, corr, linked in device:
        t = api.get(corr, ops.get(linked))
        if t is None:
            continue
        for s, rs in spans.items():
            if _holding(t, rs) is not None:
                table[s]["kernels"] += 1
                table[s]["device_s"] += (b - a) / 1e9
    # the idle gaps of trace.reduce: the traced epoch's host interval less
    # the union of the device operations
    w0 = min(a for a, _ in harness["shuffle"])
    w1 = max(b for _, b in harness["audit"])
    segments = []
    for a, b, *_ in sorted(device):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if segments and a <= segments[-1][1]:
            segments[-1][1] = max(segments[-1][1], b)
        else:
            segments.append([a, b])
    gaps, longest = defaultdict(float), []
    edges = [w0] + [x for seg in segments for x in seg] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = next((s for s in trace.EPOCH_SPANS
                     if _holding(mid, harness[s]) is not None),
                    "between spans")
        innermost = None
        for s, rs in spans.items():
            r = _holding(mid, rs)
            if r is not None:
                table[s]["idle_s"] += (b - a) / 1e9
                if innermost is None or r[0] > innermost[0]:
                    innermost = (r[0], s)
        if innermost is not None:
            name = innermost[1]
        gaps[name] += (b - a) / 1e9
        longest.append((b - a, name))
    longest.sort(reverse=True)
    idle = sorted(([f"{s} (all gaps)", v] for s, v in gaps.items()),
                  key=lambda x: -x[1])
    idle += [[f"{s} (one gap)", d / 1e9]
             for d, s in longest[:10 - len(idle)]]
    return {"spans": table, "idle_gaps": idle[:10],
            "audits": len(harness["audit"])}


def numbers(program: dict | None, steps: int) -> dict:
    """The six metrics in milliseconds (``METRICS``), each None where its
    span is missing; the per-step ones also where the ``train.step``
    ranges do not count the epoch's ``steps`` live steps."""
    out = dict.fromkeys(METRICS)
    if program is None:
        return out
    table = program["spans"]
    counted = table.get("train.step", {}).get("calls", 0)
    per = {"step": counted if counted and counted == steps else 0,
           "audit": program["audits"]}
    for metric, (span, field, by) in METRICS.items():
        if span in table and per[by]:
            out[metric] = table[span][field] * 1e3 / per[by]
    return out


def profile(cell):
    """``trace.profile_epoch(cell)``, the benchmark's traced epoch, with
    the program's spans reduced from the same events: (``Traced``, the
    program's reduction, the epoch's counts)."""
    kept = {}
    harness_reduce = trace.reduce

    def both(events, steps):
        kept["program"] = reduce_program(events)
        return harness_reduce(events, steps)

    trace.reduce = both
    try:
        traced, done = trace.profile_epoch(cell)
    finally:
        trace.reduce = harness_reduce
    return traced, kept["program"], done


def report(spec: dict, seed: int, device: str = "cuda",
           log=sys.stderr) -> dict:
    """Set up the cell ``spec`` (``run.load_spec``) as a run does, run one
    epoch, then trace one: the result object of :func:`main`."""
    driver = importlib.import_module(
        f"port_bench.drivers.{spec['workload']['driver']}")
    cell = driver.Driver(spec, seed, device)
    cell.setup()
    cell.epoch()
    traced, program, done = profile(cell)
    cell.release()
    result = {"metrics": numbers(program, done.steps), "steps": done.steps}
    if program is not None:
        for span, row in sorted(program["spans"].items()):
            print(f"program span {span}: {json.dumps(row)}", file=log)
        result.update(spans=program["spans"],
                      idle_gaps=program["idle_gaps"])
    if traced is not None:
        result["kernels_per_step"] = (traced.kernels.get("train", 0)
                                      / max(traced.steps, 1))
        result["harness"] = {s: {"kernels": traced.kernels.get(s, 0),
                                 "device_s": traced.device_s.get(s, 0.0)}
                             for s in ("train", "preprocess")}
    return result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    from port_bench.run import load_spec

    spec = load_spec(ROOT, args.workload)
    cache = ROOT / "build" / "port_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("port_bench.program_spans: needs a CUDA device",
              file=sys.stderr)
        return 2
    print(json.dumps(report(spec, args.seed % 2**63)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

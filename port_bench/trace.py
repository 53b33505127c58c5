"""The traced epoch: ``torch.profiler`` over one steady epoch after the
window, reduced to what the per-layer metrics and the breakdown read.

A device operation belongs to the harness span (``port_bench.spans``)
inside which the host launched it: the profiler ties each operation to
the CUDA call that launched it, and that call's start time to the span
that holds it, whichever thread made it (autograd's backward runs on its
own). Device busy time is the union of every device operation's interval
(kernels, copies and fills; not the profiler's own range markers) inside
the traced epoch's host interval. An idle gap between two device
operations is named by the span the host was in at its midpoint.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

import torch

from port_bench.spans import PREFIX

#: the spans an epoch runs through, outermost first
EPOCH_SPANS = ("shuffle", "train", "fetch", "audit")


def kernel_group(name: str) -> str:
    """A device kernel's group by its name (a frozen copy of the grouping
    of the repository's ``chip_smoke.py``)."""
    low = name.lower()
    if "preprocess" in low or "crop_sums" in low:
        return "preprocess kernel (port)"
    if "depthwise" in low:
        return "depthwise convolution"
    if "nchwtonhwc" in low or "nhwctonchw" in low:
        return "layout conversion (cuDNN)"
    if any(w in low for w in ("cudnn", "conv", "fprop", "dgrad", "wgrad")):
        return "convolution (cuDNN)"
    if any(w in low for w in ("gemm", "cublas", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


class Traced(NamedTuple):
    window_s: float               # the traced epoch's host interval
    busy_s: float                 # device busy time inside it
    kernels: dict                 # span -> device kernels launched in it
    device_s: dict                # span -> their device seconds
    calls: dict                   # span -> how many times it ran
    steps: int                    # live train steps of the epoch
    device_ops: list              # [[kernel name, seconds]], top 10
    idle_gaps: list               # [[span, seconds]], top 10
    groups: dict                  # kernel group -> device seconds
    operations: int               # device operations in the profile
    launches: int                 # of them, tied to a launch on the host


def _inside(t: float, ranges: list) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint ``ranges``."""
    i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
    return i >= 0 and ranges[i][0] <= t <= ranges[i][1]


def reduce(events, steps: int) -> Traced | None:
    """Reduce a profile's raw events (``kineto_results.events()``); None
    when it holds no device operation or no epoch span. A device
    operation's launch is the CUDA runtime or driver call with its
    correlation id (any launch, also from a library the program loads
    itself), else the operator it is linked to."""
    cpu = torch.autograd.DeviceType.CPU
    ranges: dict[str, list] = defaultdict(list)
    api, ops = {}, {}             # correlation id -> host start ns
    device = []                   # (start ns, end ns, name, corr, linked)
    for e in events:
        name = e.name()
        ours = name.startswith(PREFIX)
        if e.device_type() == cpu:
            if ours:
                ranges[name[len(PREFIX):]].append((e.start_ns(),
                                                   e.end_ns()))
            elif name.startswith("cu"):
                api[e.correlation_id()] = e.start_ns()
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = e.start_ns()
        elif not ours and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), name,
                           e.correlation_id(), e.linked_correlation_id()))
    if not device or not all(ranges.get(s) for s in EPOCH_SPANS):
        return None
    for rs in ranges.values():
        rs.sort()
    w0 = min(a for a, _ in ranges["shuffle"])
    w1 = max(b for _, b in ranges["audit"])
    kernels, device_ns = defaultdict(int), defaultdict(float)
    by_name, groups = defaultdict(float), defaultdict(float)
    launches = 0
    for a, b, name, corr, linked in device:
        t = api.get(corr, ops.get(linked))
        by_name[name] += b - a
        groups[kernel_group(name)] += (b - a) / 1e9
        if t is None:
            continue
        launches += 1
        for span, rs in ranges.items():
            if _inside(t, rs):
                kernels[span] += 1
                device_ns[span] += b - a
    segments = []
    for a, b, *_ in sorted(device):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if segments and a <= segments[-1][1]:
            segments[-1][1] = max(segments[-1][1], b)
        else:
            segments.append([a, b])
    busy = sum(b - a for a, b in segments)
    gaps, longest = defaultdict(float), []
    edges = [w0] + [x for seg in segments for x in seg] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        span = next((s for s in EPOCH_SPANS if _inside(mid, ranges[s])),
                    "between spans")
        gaps[span] += (b - a) / 1e9
        longest.append((b - a, span))
    longest.sort(reverse=True)
    idle = sorted(([f"{s} (all gaps)", v] for s, v in gaps.items()),
                  key=lambda x: -x[1])
    idle += [[f"{s} (one gap)", d / 1e9]
             for d, s in longest[:10 - len(idle)]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Traced(
        window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
        kernels=dict(kernels),
        device_s={k: v / 1e9 for k, v in device_ns.items()},
        calls={k: len(v) for k, v in ranges.items()}, steps=steps,
        device_ops=[[n[:160], ns / 1e9] for n, ns in top],
        idle_gaps=idle[:10], groups=dict(groups), operations=len(device),
        launches=launches)


def profile_epoch(cell) -> tuple[Traced | None, object]:
    """Run one epoch of ``cell`` under the profiler; (its reduction, the
    epoch's counts)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = cell.device.type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        # a process's first session can come back without device records
        with profile(activities=activities):
            torch.ones(1, device=cell.device).add_(1)
            torch.cuda.synchronize()
        torch.cuda.synchronize()
    cell.spans.profiling = True
    try:
        with profile(activities=activities) as prof:
            done = cell.epoch()
            if on_card:
                torch.cuda.synchronize()
    finally:
        cell.spans.profiling = False
    return reduce(prof.profiler.kineto_results.events(), done.steps), done

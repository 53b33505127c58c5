"""The depthwise convolutions' share of their roofline: the least time of
the traced epoch's depthwise convs (``port_bench.depthwise``: the bytes
of its live train steps and its audit over the memory peak) over the
device seconds of the kernel group "depthwise convolution". None where
the cell's driver left no bound."""

from port_bench import depthwise


def read(run):
    t, bound = run.traced, depthwise.left
    if t is None or bound is None or run.peaks is None or not t.steps:
        return None
    spent = t.groups.get(depthwise.GROUP)
    if not spent:
        return None
    moved = bound.epoch_bytes(t.steps, t.calls.get("audit", 0),
                              run.audit_rows)
    return 100.0 * moved / run.peaks["memory_bytes_per_s"] / spent

"""The train preprocess's share of its roofline: the least time of the
traced epoch's preprocess calls (``port_bench.bounds``: the larger of
their bytes over the memory peak and their operations over the float32
peak), over the device time of every kernel launched inside the span
``preprocess``, whatever the kernels are named."""


def read(run):
    t = run.traced
    if t is None or run.preprocess_bound_s is None:
        return None
    calls, spent = t.calls.get("preprocess", 0), t.device_s.get("preprocess")
    if not calls or not spent:
        return None
    return 100.0 * calls * run.preprocess_bound_s / spent

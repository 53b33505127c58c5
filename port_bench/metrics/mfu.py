"""The whole step's share of the device's dense bf16 peak: the window's
contraction FLOPs (the train steps' forward and backward and the audits'
forwards, counted on the benchmark's plain reference at the cell's
shapes, ``port_bench.flops``) over the window's elapsed time times the
peak (``port_bench.peaks``)."""


def read(run):
    if run.flops is None or run.peaks is None or run.elapsed_s <= 0:
        return None
    done = (run.images * run.flops["train"]
            + run.audits * run.audit_rows * run.flops["eval"])
    return 100.0 * done / (run.elapsed_s * run.peaks["bf16_flops"])

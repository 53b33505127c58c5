"""Host milliseconds of one audit: the span ``audit`` (the eval passes
over the whole test arena and the record, held on the host), averaged
over the window's audits."""


def read(run):
    n = run.span_n.get("audit", 0)
    return run.span_s["audit"] * 1e3 / n if n else None

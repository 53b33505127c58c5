"""Host milliseconds of the window's training per live step: the spans
``train`` and ``fetch`` of every epoch (the calls, then the one fetch of
the step metrics that waits for them), summed, over the live steps."""


def read(run):
    if not run.steps:
        return None
    return (run.span_s.get("train", 0.0) + run.span_s.get("fetch", 0.0)) \
        * 1e3 / run.steps

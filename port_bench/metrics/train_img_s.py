"""Training images of the live steps the window completed, over the
window's elapsed host time, its audits included."""


def read(run):
    return run.images / run.elapsed_s if run.elapsed_s > 0 else None

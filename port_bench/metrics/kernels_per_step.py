"""Device kernels launched inside the span ``train`` of the traced epoch,
per live train step: the host's dispatch load of a step."""


def read(run):
    t = run.traced
    if t is None or not t.steps or not t.kernels.get("train"):
        return None
    return t.kernels["train"] / t.steps

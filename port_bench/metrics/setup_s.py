"""Host seconds from the process's start to the window's first step:
imports, the cohort and weights, the train state, the kernel build where
the checkout has none, the first audit and the first three train
steps."""


def read(run):
    return run.setup_s

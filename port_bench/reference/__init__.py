"""The benchmark's plain reference: the models, the preprocess, the draws,
the optimizers and the audit records, written in plain PyTorch and NumPy
from their published descriptions.

Nothing here imports the program under test, JAX or the JAX package. The
reference takes the benchmark's own inputs (arenas, labels, group codes,
weights and seeds) and works out everything else itself; it reads the
program's outputs only to judge them (``port_bench.checks``).
"""

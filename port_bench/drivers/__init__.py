"""The drivers: one module per epoch loop of the program, each with a
``Driver`` class (``port_bench.epochs.Cell``)."""

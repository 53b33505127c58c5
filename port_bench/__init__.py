"""The port's benchmark: one cell of ``BENCHMARK.json`` a run
(``port_bench/run.py``), every piece found by its name."""

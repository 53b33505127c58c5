"""The benchmark's metrics, one module each, found by the metric's name
in ``BENCHMARK.json``. Each has ``read(run)``: the metric's value from a
finished run (``port_bench.run.Run``), or None when the run has nothing
for it to read, in which case the harness leaves it out of the result.
"""

"""The port's benchmark (``BENCHMARK.json``): ``python3 gbdt_bench/run.py``."""

"""The port's benchmark harness (run with ``python3 portbench/run.py``).

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, its traffic mix under ``portbench/traffic/`` and one
reader per per-layer metric under ``portbench/metrics/``. Nothing here
imports JAX or the JAX package; the reference under
``portbench/reference/`` imports nothing of the port either.
"""

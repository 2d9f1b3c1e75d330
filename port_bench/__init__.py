"""The benchmark of `nanowakeword_tpu_torch` (BENCHMARK.json's harness).

Importing this package imports nothing else; `python3 -m port_bench`
runs one cell (run.py).
"""

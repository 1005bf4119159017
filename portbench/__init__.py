"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One run trains one cell (a configuration of ``configs/`` under a traffic
mix of ``traffic/``, both named by ``BENCHMARK.json``) through the port's
train step for a fixed number of seconds, checks the port's first three
steps against the plain reference of ``reference/``, and prints one JSON
line.  ``python3 portbench/run.py --help`` lists the arguments; PERF.md
says how to add a configuration, a mix, a per-layer metric or a cell.
"""

"""The benchmark of the PyTorch and CUDA port (``alphazero_general_tpu_torch``).

One command runs one cell once::

    python3 -m azbench.run --workload c4.selfplay --seed 7 --seconds 30 --trace 0

``BENCHMARK.json`` at the repository root names the cells; each cell names a
configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``), whose ``driver`` names the module under
``drivers/`` that drives the program. Each per-layer metric is a reader of
its own under ``metrics/<name>.py``. The plain reference that decides
``correct`` lives under ``reference/`` and imports nothing of the program.
README.md says how to add a cell, a configuration, a mix or a metric.
"""

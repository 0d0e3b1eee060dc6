"""Benchmark of ``krylov_robustness_torch`` on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

A cell pairs a configuration (``configs/<name>.json``: a graph generator
under ``generators/`` and its sizes) with a traffic mix
(``mixes/<name>.json``: the protocol's parameters and the driver under
``drivers/`` that runs it). Each per-layer metric is a reader of its own,
``metrics/<name>.py``. The plain references that decide ``correct`` live in
``reference/`` and import nothing of the port; each cell's limits are
``limits/<cell>.json``. Everything is found by the
names in ``BENCHMARK.json``, so a new configuration, mix, driver or metric
is new files plus new entries.
"""

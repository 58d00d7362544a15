"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  The
cells, configurations, traffic mixes and metrics are files found by name:
``workloads/<cell>.json``, ``configs/<config>.json``, ``traffic/<mix>.json``
and ``metrics/<metric>.py``.
"""

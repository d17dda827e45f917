"""Benchmark of the PyTorch and CUDA port (``repro_torch``) on the card.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>``; cells, configurations and metrics are named in ``BENCHMARK.json``
and found here by name (see ``run.py``)."""

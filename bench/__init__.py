"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one command,
``python3 bench/run.py``, runs a cell of ``BENCHMARK.json`` on the card and
prints its result line.  Configurations, traffic mixes, cells and metrics are
files of their own under this directory, found by name."""

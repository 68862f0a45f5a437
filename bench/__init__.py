"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell (``run.py``); ``BENCHMARK.json`` at the root of the
checkout names the cells, their configurations, traffic mixes and
metrics, each a file of this folder."""

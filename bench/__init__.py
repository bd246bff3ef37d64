"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command,
``python3 bench/run.py``, runs one cell of ``BENCHMARK.json`` once."""

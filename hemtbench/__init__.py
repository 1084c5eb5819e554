"""Benchmark of the PyTorch and CUDA port (``repro_torch``) on one GPU.

``run.py`` is the entry point; ``BENCHMARK.json`` at the repository root
names the cells, and the files under ``configs/``, ``traffic/``,
``metrics/``, ``reference/``, ``counts/`` and ``limits/`` describe them
(see ``README.md``). Nothing here imports JAX or the JAX package.
"""

"""Benchmark of the PyTorch + CUDA port on one H100: ``python3 -m rodbench.run``.

Driven by data: a cell of ``BENCHMARK.json`` names a configuration
(``configs/``), whose ``entry`` names the module that calls the program
(``entries/``), and a traffic mix (``traffic/``); each metric has a reader of
its own (``metrics/``).  The plain references are in ``reference/``.  Nothing
here imports JAX or the JAX package.
"""

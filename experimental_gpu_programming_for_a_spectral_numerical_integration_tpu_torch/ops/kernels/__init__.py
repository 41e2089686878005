"""Hand-written CUDA kernels (sources in ``csrc/``) and their plain versions.

The modules import without a CUDA toolkit; a kernel is compiled at its
first launch on a CUDA tensor.
"""

"""Plain PyTorch references of the benchmark's configurations.

Independent of the program under test: they import nothing of the port and
nothing of the JAX package, and take only the inputs the benchmark makes.
"""

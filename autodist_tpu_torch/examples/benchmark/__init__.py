"""Benchmark entry points of the port (``examples/benchmark/`` in the JAX package)."""

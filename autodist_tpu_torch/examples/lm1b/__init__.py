"""lm1b entry points of the port (``examples/lm1b/`` in the JAX package)."""

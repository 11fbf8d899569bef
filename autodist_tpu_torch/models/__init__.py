"""Models of the port, with the JAX model zoo's parameter names and layouts."""

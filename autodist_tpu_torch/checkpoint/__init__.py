"""Checkpoints under the JAX package's names and formats."""

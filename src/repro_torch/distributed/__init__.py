"""Checkpoints in the JAX package's format and gradient compression."""

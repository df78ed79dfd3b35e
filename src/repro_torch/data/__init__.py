"""Synthetic data of the port: the JAX package's deterministic token
streams as tensors."""

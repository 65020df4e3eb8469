"""Tensor ops of the port (PyTorch)."""

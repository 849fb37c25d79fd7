"""Kernels and attention of the PyTorch port."""

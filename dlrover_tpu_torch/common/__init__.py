"""Shared utilities of the PyTorch port."""

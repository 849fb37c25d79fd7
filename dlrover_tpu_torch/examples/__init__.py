"""Runnable examples of the PyTorch port."""

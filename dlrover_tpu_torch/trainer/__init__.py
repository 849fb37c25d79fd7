"""Trainer and executor of the PyTorch port."""

"""Model families of the PyTorch port."""

"""Device planning, strategy and the train step of the PyTorch port."""

"""launch layer of the PyTorch port."""

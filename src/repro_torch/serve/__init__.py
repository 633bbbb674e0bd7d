"""serve layer of the PyTorch port."""

"""kernels layer of the PyTorch port."""

"""core layer of the PyTorch port: the NVR simulator (``nvr``), a copy of
the reference's numpy-only ``repro.core.nvr``."""

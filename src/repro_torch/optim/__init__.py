"""optim of the PyTorch port (mirrors ``repro.optim``)."""

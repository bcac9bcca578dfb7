"""Static and runtime checks of the PyTorch port (mirrors ``repro.analysis``)."""

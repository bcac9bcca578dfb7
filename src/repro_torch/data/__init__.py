"""data of the PyTorch port (mirrors ``repro.data``)."""

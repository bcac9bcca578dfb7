"""checkpoint of the PyTorch port (mirrors ``repro.checkpoint``)."""

"""Check programs of the PyTorch port (mirrors ``repro.testing``): each runs
a mesh of ranks, as spawned ``torch.distributed`` processes (gloo on the
CPU) or as the virtual mesh in one process."""

"""llama2-7b [dense]: the paper's own evaluation model (§4.1: d=128, 32 heads
MHA).  Used by the Figure-6 / Table-1 benchmarks, not part of the 10-arch
assignment grid.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
)

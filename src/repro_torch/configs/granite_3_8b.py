"""granite-3-8b [dense]: 40L d4096 32H (GQA kv=8) d_ff 12800, vocab 49155.

[hf:ibm-granite/granite-3.0-8b-base] GQA, swiglu, rmsnorm, tied embeddings.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10000.0,
    tie_embeddings=True,
)

"""olmo-1b [dense]: 16L d2048 16H (MHA kv=16) d_ff 8192, vocab 50304.

[arXiv:2402.00838] non-parametric LayerNorm, swiglu, tied embeddings.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparam_ln",
    tie_embeddings=True,
)

"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) d_ff 7680, vocab 256k.

[arXiv:2402.19427] RG-LRU + local attention (window 2048), pattern
(rec, rec, attn).  Recurrences use the SP prefix scan; local attention uses
halo exchange; decode uses a ring-buffer window cache -> long_500k runnable.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab_size=256000,
    window=2048,
    lru_width=2560,
    block_pattern=("rec", "rec", "attn"),
    layout="contig",
    subquadratic=True,
    tie_embeddings=True,
)

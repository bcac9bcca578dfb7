"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free, vocab 65024, state 16.

[arXiv:2410.05355] Mamba-1 architecture; TokenRing inapplicable (no attention)
— uses the SP chunked-recurrence substrate (``core/recurrence.py``).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    dt_rank=256,
    scan_chunk=32,
    layout="contig",
    subquadratic=True,
    norm_type="rmsnorm",
)

"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (GQA kv=4) MoE 128e top-8 d_ff=768.

[hf:Qwen/Qwen3-30B-A3B] qk_norm, head_dim 128, vocab 151936.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,  # per-expert intermediate
    moe_d_ff=768,
    n_experts=128,
    n_experts_per_token=8,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)

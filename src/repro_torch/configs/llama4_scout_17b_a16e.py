"""llama4-scout-17b-a16e [moe]: 48L d5120 40H (GQA kv=8) MoE 16e top-1 +
shared expert, d_ff=8192 per expert.  [hf:meta-llama/Llama-4-Scout-17B-16E]

"Early fusion" refers to the multimodal token stream; the assignment lists
this as [moe] (text backbone), so no vision stub here.  ~17B active / ~103B
total, matching the -17b-a16e naming.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=8192,
    moe_d_ff=8192,
    n_experts=16,
    n_experts_per_token=1,
    n_shared_experts=1,
    vocab_size=202048,
    rope_theta=5e5,
)

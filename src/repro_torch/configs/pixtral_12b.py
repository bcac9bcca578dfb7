"""pixtral-12b [vlm]: 40L d5120 32H (GQA kv=8) d_ff 14336, vocab 131072.

[hf:mistralai/Pixtral-12B-2409] mistral-nemo text backbone; the pixtral-ViT
frontend is a STUB: input_specs() provides patch embeddings (B, 1024, d)
prepended to the token stream (no LM loss over the image prefix).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e9,
    frontend_tokens=1024,
)

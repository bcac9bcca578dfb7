"""whisper-base [audio]: 6L enc + 6L dec, d512 8H d_ff 2048, vocab 51865.

[arXiv:2212.04356] Conv/mel frontend is a STUB: the batch provides frame
embeddings (B, enc_seq, d).  enc_seq is padded from whisper's 1500 to 1536 so
the encoder sequence shards evenly over the SP ranks.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,       # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm_type="layernorm",
    mlp_type="gelu",
    tie_embeddings=True,
    enc_seq=1536,
    layout="contig",
)

"""Architecture configuration (copy of ``repro.models.config``).

One dataclass covers every family; the port builds all of them.

Every field that matters for an arch is explicit; registry code dispatches on
``family``.  Reduced ("smoke") variants are produced by :meth:`ArchConfig.reduced`
so smoke tests always exercise the same code path as the full config.
"""

from __future__ import annotations

from dataclasses import dataclass

import dataclasses


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int | None = None  # default d_model // n_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: int | None = None  # sliding window (local-attention layers)
    causal: bool = True

    # norms / mlp
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    norm_eps: float = 1e-6
    mlp_type: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_experts_per_token: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # SSM (mamba1)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    dt_rank: int | None = None
    scan_chunk: int = 64  # chunked selective-scan block (memory knob)

    # hybrid (recurrentgemma)
    lru_width: int | None = None
    block_pattern: tuple[str, ...] = ()  # e.g. ("rec", "rec", "attn")

    # enc-dec (whisper backbone)
    n_enc_layers: int = 0
    enc_seq: int = 0  # encoder (frontend-stub) sequence length

    # vlm frontend stub
    frontend_tokens: int = 0  # image patch tokens prepended to the text

    # numerics / execution
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"  # storage dtype (bf16 for pure serving)
    remat: str = "full"  # none | full | dots  (scan-over-layers remat policy)
    logits_chunk: int = 1024  # chunked cross-entropy block
    layout: str = "zigzag"  # seq layout for SP attention (contig for ssm/hybrid)
    subquadratic: bool = False  # True -> long_500k decode shape is runnable

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_resolved(self) -> int:
        return self.dt_rank if self.dt_rank is not None else max(self.d_model // 16, 1)

    def reduced(self, **overrides) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4 if not self.block_pattern else len(self.block_pattern) + 1),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_head=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_experts_per_token=min(self.n_experts_per_token, 2)
            if self.n_experts_per_token
            else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            dt_rank=8 if self.ssm_state else None,
            lru_width=128 if self.lru_width else None,
            window=min(self.window, 64) if self.window else None,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=64 if self.enc_seq else 0,
            frontend_tokens=16 if self.frontend_tokens else 0,
            scan_chunk=16,
            logits_chunk=64,
            dtype="float32",
            remat="none",
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def with_(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the assigned input-shape cells."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

"""Attention API the models call (port of the single-device part of
``repro.core.api``).

:class:`ParallelContext` carries the kernel choice and tiles of one model
instance and the device it runs on.  Only sequence-parallel degree 1 is
ported: the mesh, the strategy planner and the ring schedules come with the
multi-card slices.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels.ref import normalize_positions

__all__ = ["ParallelContext", "sp_decode", "sp_decode_paged", "sp_prefill"]


@dataclass(frozen=True)
class ParallelContext:
    """Static description of how a model instance runs."""

    impl: str = "auto"  # kernel impl: auto | cuda | torch
    block_q: int = 512
    block_k: int = 512
    # Decode-path KV tile (None inherits block_k) of the plain version; the
    # fused paged kernel tiles by page.
    block_k_decode: int | None = None
    device: str = "cuda"

    @property
    def decode_block_k(self) -> int:
        return self.block_k_decode if self.block_k_decode is not None else self.block_k


def sp_decode(q, k_cache, v_cache, k_pos, q_pos, *, pctx: ParallelContext,
              window: int | None = None, scale: float | None = None):
    """Decode attention: ``q (B,Sq,Hq,D)`` with small Sq against the cache
    ``(B,Skv,Hkv,D)``; ``k_pos (B,Skv)`` (``PAD_POS`` for unwritten slots),
    ``q_pos (B,Sq)``."""
    from repro_torch.kernels.ops import flash_attention

    B = q.shape[0]
    q_pos = normalize_positions(q_pos, B, q.shape[1], q.device)
    k_pos = normalize_positions(k_pos, B, k_cache.shape[1], q.device)
    out, _ = flash_attention(
        q, k_cache, v_cache, q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
        scale=scale, impl=pctx.impl, block_k=pctx.block_k,
    )
    return out


def sp_decode_paged(q, k_pool, v_pool, pos_pool, block_tables, q_pos, lengths, *,
                    pctx: ParallelContext, window: int | None = None,
                    scale: float | None = None):
    """Fused paged decode: no materialized KV gather on the kernel path."""
    from repro_torch.core.decode import sp_paged_decode_attention

    return sp_paged_decode_attention(
        q, k_pool, v_pool, pos_pool, block_tables, q_pos, lengths=lengths, window=window,
        scale=scale, impl=pctx.impl, block_k=pctx.decode_block_k,
    )


def sp_prefill(q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, q_pos, *,
               pctx: ParallelContext, window: int | None = None,
               scale: float | None = None):
    """Chunked-prefill attention: the chunk ``(B,C,H,D)`` against the
    resident cache holding every *previous* chunk, merged with the chunk's
    own causal block.  The caller writes the chunk's K/V afterwards."""
    from repro_torch.core.decode import sp_prefill_chunk_attention

    B, C = q.shape[0], q.shape[1]
    q_pos = normalize_positions(q_pos, B, C, q.device)
    new_pos = normalize_positions(new_pos, B, C, q.device)
    k_pos = normalize_positions(k_pos, B, k_cache.shape[1], q.device)
    return sp_prefill_chunk_attention(
        q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, q_pos=q_pos, window=window,
        scale=scale, impl=pctx.impl, block_q=pctx.block_q, block_k=pctx.block_k,
    )

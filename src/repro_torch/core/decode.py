"""Single-device decode and chunked-prefill attention (port of the
``axis_names=()`` branches of ``repro.core.decode``).

On one device the local ``(out, lse)`` partial is the whole answer, so each
function finalizes it.  The multi-card lse-weighted merge
(``psum_merge_partials``) waits for the multi-card slice.
"""

from __future__ import annotations

from repro_torch.core.merge import finalize, merge_partials
from repro_torch.kernels.ops import flash_attention, paged_decode_attention

__all__ = ["sp_decode_attention", "sp_paged_decode_attention", "sp_prefill_chunk_attention"]


def sp_decode_attention(q, k_cache, v_cache, k_pos, *, q_pos, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        impl: str = "auto", block_k: int = 512, return_lse: bool = False):
    """``q (B,Sq,Hq,D)`` against the cache ``(B,S,Hkv,D)`` with positions
    ``k_pos (B,S)`` (``PAD_POS`` in unwritten slots)."""
    Sq = q.shape[1]
    out, lse = flash_attention(
        q, k_cache, v_cache, q_pos=q_pos, k_pos=k_pos, causal=causal, window=window,
        scale=scale, impl=impl, block_q=max(Sq, 1), block_k=block_k,
    )
    out, lse = finalize(out, lse)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def sp_paged_decode_attention(q, k_pool, v_pool, pos_pool, block_tables, q_pos, *,
                              lengths=None, window: int | None = None,
                              scale: float | None = None, impl: str = "auto",
                              block_k: int | None = None, return_lse: bool = False):
    """Paged decode attention: the fused kernel (or its gather oracle) over
    the whole pool, finalized."""
    out, lse = paged_decode_attention(
        q, k_pool, v_pool, pos_pool, block_tables, q_pos, lengths=lengths, window=window,
        scale=scale, block_k=block_k, impl=impl,
    )
    out, lse = finalize(out, lse)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def sp_prefill_chunk_attention(q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, *, q_pos,
                               window: int | None = None, scale: float | None = None,
                               impl: str = "auto", block_q: int = 512, block_k: int = 512,
                               return_lse: bool = False):
    """Chunked prefill: two partials, one Update().

    Partial 1 is the chunk's queries against the resident cache (every
    *previous* chunk; ``k_pos`` must be the pre-chunk positions).  Partial 2
    is the chunk against its own K/V, causally.  Their merge is exactly the
    one-shot prefill.
    """
    res_out, res_lse = sp_decode_attention(
        q, k_cache, v_cache, k_pos, q_pos=q_pos, causal=True, window=window, scale=scale,
        impl=impl, block_k=block_k, return_lse=True,
    )
    blk_out, blk_lse = flash_attention(
        q, k_new, v_new, q_pos=q_pos, k_pos=new_pos, causal=True, window=window,
        scale=scale, impl=impl, block_q=min(block_q, max(q.shape[1], 1)), block_k=block_k,
    )
    out, lse = merge_partials(res_out, res_lse, blk_out, blk_lse)
    out, lse = finalize(out, lse)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out

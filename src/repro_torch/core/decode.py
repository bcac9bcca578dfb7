"""Sequence-parallel decode and chunked-prefill attention: TokenRing's
serving face (port of ``repro.core.decode``).

During serving the KV cache is large while the query side is small (one
token a request in decode, one prompt chunk in prefill).  The cache stays
sequence-sharded, the small query is replicated, every rank computes a
partial ``(out, lse)`` against its cache shard with the flash kernel, and the
partials are merged across the ranks with the paper's Update() equations,
as an lse-weighted all-reduce (:func:`psum_merge_partials`).

Each function takes ``ring``, a transport of ``core.collectives`` (``None``
on one device, where the local partial is the whole answer and is only
finalized):

* on the **virtual ring** (``ring.folded``) every rank's cache rows are
  folded into the batch dimension: ``(P*B, S_loc, Hkv, D)``, rank ``r``'s
  shard in rows ``[r*B, (r+1)*B)``, while ``q`` is given once, ``(B, ...)``,
  and replicated over the ranks here; the result is ``(B, ...)``;
* on a **process group** each rank passes its own shard and the replicated
  query, and gets the replicated result.

Two schedules, registered as ``SPStrategy`` entries so that
``ParallelContext.plan_decode`` / ``plan_prefill`` price them with the cost
machinery the training planner uses:

``"decode"``  -- :func:`sp_decode_attention`: a small Q, one all-reduce merge.
  Per step ``B * Hq * (D + 2)`` float32 scalars (numerator ``D``,
  denominator 1, lse max 1), independent of the context length.

``"prefill"`` -- :func:`sp_prefill_chunk_attention`: a C-token chunk against
  the resident cache of every previous chunk (the same merge, C query rows)
  and against its own K/V, causally, as a local partial; the two partials
  combine with :func:`repro_torch.core.merge.merge_partials`, so chunked
  prefill is numerically the one-shot prefill.  Per chunk ``B * C * Hq *
  (D + 2)`` float32 scalars.
"""

from __future__ import annotations

import torch

from repro_torch.core.merge import finalize, merge_partials
from repro_torch.core.strategies import CommCost, register_strategy
from repro_torch.kernels.ops import flash_attention, paged_decode_attention

__all__ = [
    "sp_decode_attention",
    "sp_paged_decode_attention",
    "sp_prefill_chunk_attention",
    "psum_merge_partials",
    "stripe_remap",
    "folded_stripe_tables",
    "decode_comm_cost",
    "prefill_comm_cost",
]


def _active(ring) -> bool:
    return ring is not None and ring.size > 1


def psum_merge_partials(out, lse, ring):
    """Merge the ranks' attention partials: the paper's Update() as an
    all-reduce.  With ``w_i = exp(lse_i - max_j lse_j)``,

        out = sum_i w_i * out_i / sum_i w_i
        lse = max_j lse_j + log(sum_i w_i)

    ``out (R*B, ..., H, D)`` / ``lse (R*B, ..., H)`` hold the ranks'
    partials as the ring lays them out (``R = P`` folded rows on the virtual
    ring, this rank's ``B`` rows on a process group).  Empty partials
    (``lse = -inf``) weigh 0.  Returns the merged, *mergeable* ``(out (B,
    ...), lse)``, replicated; a row whose ranks are all empty comes back as
    ``(0, -inf)``.

    Wire cost: a ``max`` of ``(..., H)`` and one ``sum`` of the
    concatenated numerator and denominator ``(..., H, D+1)``, all float32,
    independent of the cache length.
    """
    D = out.shape[-1]
    m = ring.all_reduce(lse, "max")
    lse_r = ring.rank_view(lse)
    w = torch.exp(torch.where(torch.isneginf(m), 0.0, lse_r - m))
    w = torch.where(torch.isneginf(lse_r), 0.0, w)
    payload = torch.cat([w[..., None] * ring.rank_view(out).float(), w[..., None]], dim=-1)
    total = ring.all_reduce(payload.reshape(*lse.shape, D + 1), "sum")
    num, den = total[..., :D], total[..., D]
    safe = den > 0.0
    merged = num / torch.where(safe, den, 1.0)[..., None]
    merged = torch.where(safe[..., None], merged, 0.0).to(out.dtype)
    merged_lse = torch.where(safe, m + torch.log(torch.where(safe, den, 1.0)), -torch.inf)
    return merged, merged_lse


def sp_decode_attention(q, k_cache, v_cache, k_pos, *, q_pos, ring=None, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        impl: str = "auto", block_k: int = 512, return_lse: bool = False):
    """``q (B,Sq,Hq,D)`` with small Sq against the cache shard ``(R*B,
    S_loc,Hkv,D)`` with global positions ``k_pos (R*B, S_loc)`` (``PAD_POS``
    in unwritten slots); ``q_pos (B, Sq)``.  Returns ``(B,Sq,Hq,D)``
    replicated, plus the merged lse when ``return_lse`` (a mergeable
    partial)."""
    Sq = q.shape[1]
    qr, qpr = (ring.replicate(q), ring.replicate(q_pos)) if _active(ring) else (q, q_pos)
    out, lse = flash_attention(
        qr, k_cache, v_cache, q_pos=qpr, k_pos=k_pos, causal=causal, window=window,
        scale=scale, impl=impl, block_q=max(Sq, 1), block_k=block_k,
    )
    if _active(ring):
        out, lse = psum_merge_partials(out, lse, ring)
    else:  # one device: the local partial is the whole answer
        out, lse = finalize(out, lse)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def stripe_remap(block_tables, rank: int, n_local: int):
    """Global block tables into rank ``rank``'s local page space
    (``decode.py:165-174`` of the reference): the rank holds global pages
    ``[rank*n_local, (rank+1)*n_local)``; every other entry (another
    rank's page, or the global sentinel) becomes the local sentinel
    ``n_local``."""
    lo = rank * n_local
    bt = block_tables.to(torch.int32)
    return torch.where((bt >= lo) & (bt < lo + n_local), bt - lo, n_local).to(torch.int32)


def folded_stripe_tables(block_tables, P: int, n_pages: int):
    """The virtual ring's form of :func:`stripe_remap` over the whole pool:
    ``(P*B, W)`` tables, rank ``r``'s rows keeping the global ids of its
    stripe and the global sentinel ``n_pages`` everywhere else."""
    n_local = n_pages // P
    bt = block_tables.to(torch.int32)[None]
    ranks = torch.arange(P, dtype=torch.int32, device=bt.device)[:, None, None]
    own = (bt >= 0) & (bt < n_pages) & (torch.div(bt, n_local, rounding_mode="floor") == ranks)
    return torch.where(own, bt, n_pages).to(torch.int32).reshape(-1, bt.shape[-1])


def sp_paged_decode_attention(q, k_pool, v_pool, pos_pool, block_tables, q_pos, *, ring=None,
                              lengths=None, window: int | None = None,
                              scale: float | None = None, impl: str = "auto",
                              block_k: int | None = None, return_lse: bool = False):
    """Paged decode attention: the fused kernel (or its gather oracle) on
    every rank's page stripe, merged.

    Rank ``r`` holds the contiguous stripe of ``n_local = n_pages / P``
    global pages ``[r*n_local, (r+1)*n_local)``.  On a process group the
    pools are the rank's stripe ``(n_local, ps, Hkv, D)`` and the replicated
    global tables are remapped into its local page space
    (:func:`stripe_remap`).  On the virtual ring the pools are the whole
    pool and need no fold: each rank's rows of the table keep only its
    stripe (:func:`folded_stripe_tables`), and q is repeated over the
    ranks.  ``q (B, 1, Hq, D)``, ``q_pos (B, 1)`` and ``block_tables (B, W)``
    (global ids) are replicated; the result ``(B, 1, Hq, D)`` too."""
    bt = block_tables.to(torch.int32)
    if _active(ring):
        if ring.folded:
            bt = folded_stripe_tables(bt, ring.size, k_pool.shape[0])
        else:
            bt = stripe_remap(bt, ring.rank, k_pool.shape[0])
        q, q_pos = ring.replicate(q), ring.replicate(q_pos)
        lengths = None if lengths is None else ring.replicate(lengths)
    out, lse = paged_decode_attention(
        q, k_pool, v_pool, pos_pool, bt, q_pos, lengths=lengths, window=window, scale=scale,
        block_k=block_k, impl=impl,
    )
    if _active(ring):
        out, lse = psum_merge_partials(out, lse, ring)
    else:
        out, lse = finalize(out, lse)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def sp_prefill_chunk_attention(q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, *, q_pos,
                               ring=None, window: int | None = None,
                               scale: float | None = None, impl: str = "auto",
                               block_q: int = 512, block_k: int = 512,
                               return_lse: bool = False):
    """Chunked prefill: two partials, one Update().

    Partial 1 is the chunk's queries ``q (B,C,Hq,D)`` against the resident
    cache shard (every *previous* chunk; ``k_pos`` must be the pre-chunk
    positions), merged across the ranks.  Partial 2 is the chunk against its
    own K/V ``(B,C,Hkv,D)``, causally: once on the virtual ring (it is the
    same on every rank), on every rank of a process group, with no
    communication.  Their merge is exactly the one-shot prefill.  The
    caller writes the chunk's K/V into the cache afterwards.
    """
    res_out, res_lse = sp_decode_attention(
        q, k_cache, v_cache, k_pos, q_pos=q_pos, ring=ring, causal=True, window=window,
        scale=scale, impl=impl, block_k=block_k, return_lse=True,
    )
    blk_out, blk_lse = flash_attention(
        q, k_new, v_new, q_pos=q_pos, k_pos=new_pos, causal=True, window=window,
        scale=scale, impl=impl, block_q=min(block_q, max(q.shape[1], 1)), block_k=block_k,
    )
    out, lse = merge_partials(res_out, res_lse, blk_out, blk_lse)
    out, lse = finalize(out, lse)
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------
# cost models: the serving rows of the planner's table
# ---------------------------------------------------------------------------

# The all-reduce payload is float32 whatever the compute dtype: the merge
# accumulates in float32.
_MERGE_BYTES = 4


def decode_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True, S_kv=None,
                     table_pages=None, **_):
    """Resident-cache decode: one lse-weighted all-reduce of the partials.

    Payload a step: ``B * S * Hq * (D + 2)`` float32 scalars (``S`` query
    tokens a step, 1 in decode): the sum of the numerator ``(D)`` and the
    denominator ``(1)``, the max of the lse ``(1)``.  A bidirectional ring
    all-reduce moves ``(P-1)/P x payload`` a rank and direction,
    independent of the cache length ``S_kv``.

    ``table_pages`` prices the paged cache: the per-slot block tables
    (``B * table_pages`` int32 entries) priced as a per-step broadcast
    through the same ring (an upper bound: tables change at page
    granularity).  The page data never moves.
    """
    if P <= 1:
        return CommCost(0.0, 0.0)
    payload = B * S * Hq * (D + 2) * _MERGE_BYTES
    if table_pages:
        payload += B * table_pages * 4  # int32 block-table row broadcast
    per_dir = (P - 1) / P * payload
    return CommCost(per_dir, per_dir)


def prefill_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True, S_kv=None,
                      table_pages=None, **_):
    """Chunk-resident prefill: the decode all-reduce at ``S`` chunk rows
    (linear in the query rows only, so a whole prompt is one evaluation at
    ``S = prompt_len``); delegated so the two cannot drift apart."""
    return decode_comm_cost(B, S, Hq, Hkv, D, P, bytes_per_elem=bytes_per_elem,
                            bidir_links=bidir_links, S_kv=S_kv, table_pages=table_pages)


register_strategy(
    "decode",
    sp_decode_attention,
    comm_cost=decode_comm_cost,
    serving_side=True,
    kv_resident=True,
    auto_eligible=False,
    supports_window=True,
    extra_kwargs=frozenset({"table_pages"}),
    description="serving decode: replicated 1-token Q, resident sharded "
    "cache, lse-weighted psum merge",
)

register_strategy(
    "prefill",
    sp_prefill_chunk_attention,
    comm_cost=prefill_comm_cost,
    serving_side=True,
    kv_resident=True,
    auto_eligible=False,
    supports_window=True,
    extra_kwargs=frozenset({"table_pages"}),
    description="serving chunked prefill: replicated C-token chunk vs "
    "resident cache + local chunk block, merged via Update()",
)

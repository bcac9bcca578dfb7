"""Multi-pod hybrid: inter-pod Ring-Attention x intra-pod TokenRing (copy
of ``repro.core.hybrid``).

Paper Case Study III (Figure 5): "Ring Attention is employed for cross-node
communication of K and V, while TokenRing is utilized within individual
nodes".

The port's ``ParallelContext(pods=n)`` factors the SP ring row-major as
``(pod, inner)`` (``core.collectives``' ``split``):
  * the sequence is sharded over all ``sp_degree`` ranks in that order,
  * the *outer* loop is the classic KV ``ring_schedule`` over the pod ring,
    run by the overlap executor — the slow inter-pod transfer of the next
    pod's KV shard is posted against the resident copy and overlaps the
    whole intra-pod pass (one big, infrequent transfer on the slow links),
  * the *inner* "compute" of each outer step is a full intra-pod pass of any
    hybrid-capable strategy over the inner ring against whatever KV block is
    currently resident (fast intra-pod links carry the frequent
    bidirectional Q/out traffic): one executor runs inside another.

Because TokenRing returns the accumulators to their home rank after every
inner pass, merging across outer steps is local.
"""

from __future__ import annotations

from repro_torch.analysis.preconditions import check_even_split, require
from repro_torch.core.merge import empty_partial, finalize
from repro_torch.core.ring_attention import ring_schedule
from repro_torch.core.schedule import execute_schedule
from repro_torch.core.strategies import get_strategy

__all__ = ["hybrid_sp"]


def hybrid_sp(q, k, v, q_pos, k_pos, *, pod_ring, ring, inner: str = "tokenring",
              causal: bool = False, window: int | None = None, scale: float | None = None,
              impl: str = "auto", block_q: int = 512, block_k: int = 512,
              block_q_bwd: int | None = None, block_k_bwd: int | None = None,
              overlap: bool = True, return_lse: bool = False, **inner_kwargs):
    """Hybrid SP attention over ``pod_ring`` (outer) and ``ring`` (the inner
    ring of each pod).

    ``inner`` names any registered strategy with ``hybrid_inner_ok``;
    ``inner_kwargs`` are its declared extras (e.g. ``travel_dtype``).
    """
    desc = get_strategy(inner)
    if not desc.hybrid_inner_ok:
        raise ValueError(f"strategy {inner!r} cannot run inside the Case-Study-III hybrid")
    # A misspelled extra (e.g. ``travle_dtype``) must fail loudly, not be
    # silently dropped while the schedule runs at its default.
    unknown = set(inner_kwargs) - set(desc.extra_kwargs)
    if unknown:
        raise ValueError(
            f"unknown inner_kwargs {sorted(unknown)} for hybrid inner "
            f"strategy {inner!r}; accepted extras: "
            f"{sorted(desc.extra_kwargs) or 'none'}"
        )
    # Surface the inner schedule's split precondition at hybrid entry rather
    # than n_pods outer steps in (same catalog message either place).
    if inner == "tokenring":
        require(check_even_split(q.shape[1], what="Q block", who="token_ring variant='bidir'",
                                 alternative="variant='faithful'"))
    inner_fn = desc.fn

    def inner_pass(qq, qp, k_cur, v_cur, kp_cur):
        return inner_fn(
            qq, k_cur, v_cur, qp, kp_cur, ring=ring, causal=causal, window=window,
            scale=scale, impl=impl, block_q=block_q, block_k=block_k,
            block_q_bwd=block_q_bwd, block_k_bwd=block_k_bwd, overlap=overlap,
            return_lse=True, **inner_kwargs,
        )

    bufs = {
        "q": (q, q_pos),
        "kv": (k, v, k_pos),
        "acc": empty_partial(q.shape, device=q.device),
    }
    res = execute_schedule(ring_schedule(pod_ring.size), bufs, ring=pod_ring,
                           compute_fn=inner_pass, overlap=overlap)
    out, lse = finalize(*res["acc"])
    return (out, lse) if return_lse else out

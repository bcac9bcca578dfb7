"""Adaptive prefill rings: pass-KV vs pass-Q (copy of
``repro.core.prefill_rings``; Context Parallelism, arXiv 2411.01783, §3).

Ring prefill has two mirror-image schedules, and which one wins is a pure
byte-ratio question:

``passkv_ring`` — the KV pair circulates, Q stays home.  Per direction the
  wire carries ``(P-1) * (K+V)/2`` — linear in the *KV* length.  Right when
  the KV side is cold (full prefill: every token's K/V must visit every
  rank anyway) and the query side is at least as large.

``passq_ring``  — Q circulates with its ``(out, lse)`` accumulator lagging
  one rank behind (the TokenRing pipelining trick, single direction); KV
  stays resident.  The wire carries ``(P-1)*Q + P*(out+lse)`` — linear in
  the *query* length and independent of how much KV sits resident.  Right
  when KV dwarfs Q: the decisive case is a prefix-cache hit, where only the
  miss *suffix* needs query work but the resident prefix KV still
  participates in attention.

:meth:`ParallelContext.plan_prefill` arbitrates per request between these
two and the resident all-reduce chunk path (``core/decode.py``) from the
KV:Q byte ratio and the measured prefix-cache hit rate
(``ParallelContext.choose_prefill_strategy`` in ``core/api.py``).  Both
schedules run on the step executor (``core/schedule.py``); every Compute is
one flash call (kernel A).
"""

from __future__ import annotations

import torch

from repro_torch.analysis.preconditions import check_even_split, require
from repro_torch.core.merge import empty_partial, finalize
from repro_torch.core.schedule import (
    BufferSpec,
    Compute,
    Merge,
    Schedule,
    ScheduleSpec,
    Send,
    Step,
    execute_schedule,
)
from repro_torch.core.strategies import CommCost, LSE_BYTES, itemsize, register_strategy
from repro_torch.kernels.ops import flash_attention

__all__ = [
    "passkv_ring_sp",
    "passq_ring_sp",
    "passkv_ring_schedule",
    "passkv_ring_spec",
    "passq_ring_schedule",
    "passq_ring_spec",
    "passkv_ring_comm_cost",
    "passq_ring_comm_cost",
]


def passkv_ring_schedule(P: int) -> Schedule:
    """Pass-KV prefill ring: the two KV half-shards rotate opposite ways
    (both link directions busy), Q and the accumulator stay home.

    ``P-1`` shifts per half; each shift is issued against the copy already
    in hand while the flash consumes the halves' concatenation.
    """
    final = Step(Compute("q", ("kva", "kvb"), "p"), Merge("acc", "p"))
    if P == 1:
        return Schedule(epilogue=(final,))
    step = Step(
        Send(("kva",), 1), Send(("kvb",), -1),
        Compute("q", ("kva", "kvb"), "p"), Merge("acc", "p"),
    )
    return Schedule(
        prologue=(step,), body=step, trips=P - 2, epilogue=(final,),
        static=frozenset({"q"}),
    )


def passkv_ring_spec(P: int, **_) -> ScheduleSpec:
    """Analyzer model: two half-KV parts counter-rotate; every rank must see
    both parts of every home rank's KV."""
    return ScheduleSpec(
        schedule=passkv_ring_schedule(P),
        buffers={
            "q": BufferSpec(role="q", positions=True),
            "kva": BufferSpec(role="kv", part=0, frac=0.5, heads="kv", positions=True),
            "kvb": BufferSpec(role="kv", part=1, frac=0.5, heads="kv", positions=True),
            "acc": BufferSpec(role="acc", lse=True, bound_q="q"),
        },
        out=("acc",),
        n_kv_parts=2,
    )


def passq_ring_schedule(P: int) -> Schedule:
    """Pass-Q prefill ring: the full Q block rotates ``+1`` with its
    ``(out, lse)`` accumulator lagging one rank behind; KV stays resident.

    Per query: ``P`` flash blocks, ``P-1`` query hops, ``P`` accumulator
    hops (``P-1`` pipelined + 1 going home).  The lag means every send
    reads step-entry data — the accumulator merged through block ``i-1``
    travels while block ``i`` computes, arriving exactly when it is needed.
    """
    computes = (Compute("q", ("kv",), "p"), Merge("acc", "p"))
    if P == 1:
        return Schedule(prologue=(Step(*computes),))
    step0 = Step(Send(("q",), 1), *computes)
    body = Step(Send(("q",), 1), Send(("acc",), 1), *computes)
    last = Step(Send(("acc",), 1), *computes)
    home = Step(Send(("acc",), 1))
    return Schedule(
        prologue=(step0,), body=body, trips=P - 2, epilogue=(last, home),
        static=frozenset({"kv"}),
    )


def passq_ring_spec(P: int, **_) -> ScheduleSpec:
    """Analyzer model: one full-Q stream with a lagging travel-dtype
    accumulator, unidirectional; KV never moves."""
    return ScheduleSpec(
        schedule=passq_ring_schedule(P),
        buffers={
            "q": BufferSpec(role="q", positions=True),
            "kv": BufferSpec(role="kv", heads="kv", positions=True),
            "acc": BufferSpec(role="acc", elem="travel", lse=True, bound_q="q"),
        },
        out=("acc",),
    )


def _flash_fn(causal, window, scale, impl, block_q, block_k, block_q_bwd, block_k_bwd):
    def flash(qq, qp, kk, vv, kp):
        return flash_attention(
            qq, kk, vv, q_pos=qp, k_pos=kp, causal=causal, window=window, scale=scale,
            impl=impl, block_q=block_q, block_k=block_k, block_q_bwd=block_q_bwd,
            block_k_bwd=block_k_bwd,
        )

    return flash


def passkv_ring_sp(q, k, v, q_pos, k_pos, *, ring, causal: bool = False,
                   window: int | None = None, scale: float | None = None, impl: str = "auto",
                   block_q: int = 512, block_k: int = 512, block_q_bwd: int | None = None,
                   block_k_bwd: int | None = None, overlap: bool = True,
                   return_lse: bool = False):
    """Pass-KV prefill ring on the local shards over the transport ``ring``."""
    S = k.shape[1]
    require(check_even_split(S, what="KV shard", who="passkv_ring",
                             alternative="strategy='ring'"))
    half = S // 2
    bufs = {
        "q": (q, q_pos),
        "kva": (k[:, :half], v[:, :half], k_pos[:, :half]),
        "kvb": (k[:, half:], v[:, half:], k_pos[:, half:]),
        "acc": empty_partial(q.shape, device=q.device),
    }
    res = execute_schedule(
        passkv_ring_schedule(ring.size), bufs, ring=ring, overlap=overlap,
        compute_fn=_flash_fn(causal, window, scale, impl, block_q, block_k, block_q_bwd,
                             block_k_bwd),
    )
    out, lse = finalize(*res["acc"])
    return (out, lse) if return_lse else out


def passq_ring_sp(q, k, v, q_pos, k_pos, *, ring, travel_dtype="float32", causal: bool = False,
                  window: int | None = None, scale: float | None = None, impl: str = "auto",
                  block_q: int = 512, block_k: int = 512, block_q_bwd: int | None = None,
                  block_k_bwd: int | None = None, overlap: bool = True,
                  return_lse: bool = False):
    """Pass-Q prefill ring on the local shards over the transport ``ring``.

    ``travel_dtype``: wire format of the travelling ``out`` accumulator
    (lse always stays float32) — the same knob as TokenRing's.
    """
    dtype = getattr(torch, travel_dtype) if isinstance(travel_dtype, str) else travel_dtype
    bufs = {
        "q": (q, q_pos),
        "kv": (k, v, k_pos),
        "acc": empty_partial(q.shape, dtype=dtype, device=q.device),
    }
    res = execute_schedule(
        passq_ring_schedule(ring.size), bufs, ring=ring, overlap=overlap,
        compute_fn=_flash_fn(causal, window, scale, impl, block_q, block_k, block_q_bwd,
                             block_k_bwd),
    )
    out, lse = finalize(*res["acc"])
    return (out, lse) if return_lse else out


def passkv_ring_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True,
                          S_kv=None, **_):
    """Pass-KV: half the (K, V) shard each way, ``P-1`` shifts per half.

    Scales with the *KV* sequence (``S_kv``): the whole resident context
    circulates regardless of how many query rows ride this prefill pass.
    """
    if P <= 1:
        return CommCost(0.0, 0.0)
    S_loc = (S_kv or S) // P
    kv = 2 * B * S_loc * Hkv * D * bytes_per_elem
    return CommCost((P - 1) * kv / 2, (P - 1) * kv / 2)


def passq_ring_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True,
                         S_kv=None, travel_dtype="float32", **_):
    """Pass-Q: ``(P-1)`` query hops + ``P`` accumulator hops, one direction.

    Scales with the *query* rows (``S``) only — the ratio against
    :func:`passkv_ring_comm_cost` is what the prefill arbitration compares.
    Q travels at ``bytes_per_elem``; the ``out`` accumulator at
    ``travel_dtype``; lse always float32.
    """
    if P <= 1:
        return CommCost(0.0, 0.0)
    S_loc = S // P
    q = B * S_loc * Hq * D * bytes_per_elem
    out = B * S_loc * Hq * D * itemsize(travel_dtype)
    lse = B * S_loc * Hq * LSE_BYTES
    return CommCost((P - 1) * q + P * (out + lse), 0.0)


register_strategy(
    "passkv_ring",
    passkv_ring_sp,
    comm_cost=passkv_ring_comm_cost,
    schedule_spec=passkv_ring_spec,
    auto_eligible=False,
    hybrid_inner_ok=False,
    description="prefill pass-KV ring: counter-rotating KV halves, Q home "
    "(cold long-KV prefill)",
)

register_strategy(
    "passq_ring",
    passq_ring_sp,
    comm_cost=passq_ring_comm_cost,
    schedule_spec=passq_ring_spec,
    kv_resident=True,
    auto_eligible=False,
    hybrid_inner_ok=False,
    extra_kwargs={"travel_dtype"},
    description="prefill pass-Q ring: Q + lagging accumulator rotate, KV "
    "resident (warm-prefix / long-KV suffix prefill)",
)

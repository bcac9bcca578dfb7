"""Ring Attention baselines: the paper's Figure 3a and the
bidirectional-KV variant (copy of ``repro.core.ring_attention``).

Both receive the local sequence shard of q/k/v plus the global positions of
the local rows, and run their KV circulation as a ``core.schedule`` step
schedule: the shift of the next step's KV shard is posted against the copy
already in hand, so the transfer shares the wire with the current flash.

``ring_attention_sp`` — the paper's baseline: Q stays home, the (K, V) pair
rotates one step (+1) per iteration, over one link direction.

``ring_attention_bidir_sp`` — the KV shard is split in half, one half rotates
``+1`` while the other rotates ``-1``: both directions carry ``(K+V)/2`` per
step.

Communication per device (bytes, ``b`` = element size):
    ring        : (P-1) * 2*S_loc*Hkv*D*b      one direction only
    ring_bidir  : (P-1) *   S_loc*Hkv*D*b      per direction (both busy)
"""

from __future__ import annotations

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
from repro_torch.core.strategies import CommCost, register_strategy
from repro_torch.kernels.ops import flash_attention

__all__ = [
    "ring_attention_sp",
    "ring_attention_bidir_sp",
    "ring_schedule",
    "ring_spec",
    "ring_bidir_schedule",
    "ring_bidir_spec",
    "ring_comm_cost",
    "ring_bidir_comm_cost",
]


def ring_schedule(P: int) -> Schedule:
    """Classic KV ring: ``P-1`` unidirectional ``+1`` shifts, each posted
    before (and independent of) the flash against the resident copy; the
    last block needs no shift."""
    final = Step(Compute("q", ("kv",), "p"), Merge("acc", "p"))
    if P == 1:
        return Schedule(epilogue=(final,))
    step = Step(Send(("kv",), 1), Compute("q", ("kv",), "p"), Merge("acc", "p"))
    return Schedule(
        prologue=(step,), body=step, trips=P - 2, epilogue=(final,),
        static=frozenset({"q"}),
    )


def ring_spec(P: int, **_) -> ScheduleSpec:
    """Analyzer model of the classic KV ring."""
    return ScheduleSpec(
        schedule=ring_schedule(P),
        buffers={
            "q": BufferSpec(role="q", positions=True),
            "kv": BufferSpec(role="kv", heads="kv", positions=True),
            "acc": BufferSpec(role="acc", lse=True, bound_q="q"),
        },
        out=("acc",),
    )


def ring_bidir_schedule(P: int) -> Schedule:
    """Bidirectional KV ring: the two half-shards rotate opposite ways; each
    flash sees their concatenation."""
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


def ring_bidir_spec(P: int, **_) -> ScheduleSpec:
    """Analyzer model of the bidirectional KV ring: two half-KV parts rotate
    opposite ways; every rank must see both parts of every home."""
    return ScheduleSpec(
        schedule=ring_bidir_schedule(P),
        buffers={
            "q": BufferSpec(role="q", positions=True),
            "kva": BufferSpec(role="kv", part=0, frac=0.5, heads="kv", positions=True),
            "kvb": BufferSpec(role="kv", part=1, frac=0.5, heads="kv", positions=True),
            "acc": BufferSpec(role="acc", lse=True, bound_q="q"),
        },
        out=("acc",),
        n_kv_parts=2,
    )


def _flash_fn(causal, window, scale, impl, block_q, block_k, block_q_bwd, block_k_bwd):
    def flash(qq, qp, kk, vv, kp):
        return flash_attention(
            qq, kk, vv, q_pos=qp, k_pos=kp, causal=causal, window=window, scale=scale,
            impl=impl, block_q=block_q, block_k=block_k, block_q_bwd=block_q_bwd,
            block_k_bwd=block_k_bwd,
        )

    return flash


def ring_attention_sp(q, k, v, q_pos, k_pos, *, ring, causal: bool = False,
                      window: int | None = None, scale: float | None = None,
                      impl: str = "auto", block_q: int = 512, block_k: int = 512,
                      block_q_bwd: int | None = None, block_k_bwd: int | None = None,
                      overlap: bool = True, return_lse: bool = False):
    """Classic Ring Attention: KV rotates +1, (P-1) unidirectional sends."""
    bufs = {
        "q": (q, q_pos),
        "kv": (k, v, k_pos),
        "acc": empty_partial(q.shape, device=q.device),
    }
    res = execute_schedule(
        ring_schedule(ring.size), bufs, ring=ring, overlap=overlap,
        compute_fn=_flash_fn(causal, window, scale, impl, block_q, block_k, block_q_bwd,
                             block_k_bwd),
    )
    out, lse = finalize(*res["acc"])
    return (out, lse) if return_lse else out


def ring_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True, S_kv=None, **_):
    """Classic ring: ``(P-1)`` unidirectional (K, V) shard rotations; KV
    traffic scales with the *KV* sequence (``S_kv``)."""
    S_loc = (S_kv or S) // P
    kv = 2 * B * S_loc * Hkv * D * bytes_per_elem
    return CommCost((P - 1) * kv, 0.0)


def ring_bidir_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True,
                         S_kv=None, **_):
    """Bidirectional KV ring: half the shard each way, both directions busy."""
    S_loc = (S_kv or S) // P
    kv = 2 * B * S_loc * Hkv * D * bytes_per_elem
    return CommCost((P - 1) * kv / 2, (P - 1) * kv / 2)


def ring_attention_bidir_sp(q, k, v, q_pos, k_pos, *, ring, causal: bool = False,
                            window: int | None = None, scale: float | None = None,
                            impl: str = "auto", block_q: int = 512, block_k: int = 512,
                            block_q_bwd: int | None = None, block_k_bwd: int | None = None,
                            overlap: bool = True, return_lse: bool = False):
    """Bidirectional-KV ring: half the KV shard travels each direction."""
    S = k.shape[1]
    require(check_even_split(S, what="KV shard", who="ring_bidir", alternative="strategy='ring'"))
    half = S // 2
    bufs = {
        "q": (q, q_pos),
        "kva": (k[:, :half], v[:, :half], k_pos[:, :half]),
        "kvb": (k[:, half:], v[:, half:], k_pos[:, half:]),
        "acc": empty_partial(q.shape, device=q.device),
    }
    res = execute_schedule(
        ring_bidir_schedule(ring.size), bufs, ring=ring, overlap=overlap,
        compute_fn=_flash_fn(causal, window, scale, impl, block_q, block_k, block_q_bwd,
                             block_k_bwd),
    )
    out, lse = finalize(*res["acc"])
    return (out, lse) if return_lse else out


register_strategy(
    "ring",
    ring_attention_sp,
    comm_cost=ring_comm_cost,
    schedule_spec=ring_spec,
    description="Ring Attention baseline: KV rotates +1, one link direction",
)

register_strategy(
    "ring_bidir",
    ring_attention_bidir_sp,
    comm_cost=ring_bidir_comm_cost,
    schedule_spec=ring_bidir_spec,
    # The intra-pod half of the hybrid already has KV arriving from the pod
    # ring; splitting that transient shard across both directions again is
    # not implemented (use "ring" or "tokenring" inside).
    hybrid_inner_ok=False,
    description="bidirectional-KV ring: half the KV shard each direction",
)

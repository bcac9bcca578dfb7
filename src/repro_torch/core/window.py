"""Halo-exchange sequence-parallel sliding-window attention (copy of
``repro.core.window``).

For local attention with window ``W`` and contiguous layout, a rank holding
``S_loc`` tokens only needs the last ``W-1`` tokens of its predecessors —
``ceil((W-1)/S_loc)`` neighbour shards.  Rotating the whole KV around the
ring (TokenRing / Ring-Attention) would waste (P - halo) of the
circulation, so this strategy fetches exactly the halo — a
``core.schedule`` halo schedule (one ``+1`` flat ring shift per step, each
forwarding the shard received the step before) — and runs one windowed
flash call on the concatenation (kernel A with ``window=``; B1/B2
backward).  Used by recurrentgemma's local-attention layers and any
``window=`` config; requires ``layout="contig"``.  On a context with pods
the halo runs on the flat ring of all ranks (the reference's two-axis
``flat_ring_shift``: rank order is row-major ``(pod, inner)``).

Communication per device: ``halo * 2*S_loc*Hkv*D*b`` — independent of P.
"""

from __future__ import annotations

from repro_torch.core.schedule import (
    BufferSpec,
    Compute,
    Schedule,
    ScheduleSpec,
    Send,
    Step,
    execute_schedule,
)
from repro_torch.core.strategies import CommCost, ceil_div, register_strategy
from repro_torch.kernels.ops import flash_attention

__all__ = [
    "window_attention_sp",
    "window_halo_schedule",
    "window_spec",
    "window_comm_cost",
]


def window_halo_schedule(halo: int) -> Schedule:
    """``halo`` successive ``+1`` flat shifts (step ``j`` forwards the shard
    that arrived at step ``j-1``, so ``kv{j}`` is the ``j``-th predecessor's
    shard), then one flash over ``[kv{halo}, ..., kv1, kv0]`` — oldest first,
    matching contiguous sequence order."""
    steps = [Step(Send((f"kv{j}",), 1, into=(f"kv{j + 1}",))) for j in range(halo)]
    kv_order = tuple(f"kv{j}" for j in range(halo, -1, -1))
    steps.append(Step(Compute("q", kv_order, "p")))
    return Schedule(prologue=tuple(steps))


def window_spec(P: int, *, S_loc: int, window: int | None = None, **_):
    """Analyzer model of the halo exchange: each rank ends up attending its
    own shard plus exactly its ``halo`` predecessors (never the full ring)."""
    halo = 0 if not window else min(P - 1, ceil_div(window - 1, S_loc))
    buffers = {
        "q": BufferSpec(role="q", positions=True),
        "kv0": BufferSpec(role="kv", heads="kv", positions=True),
    }
    for j in range(1, halo + 1):
        buffers[f"kv{j}"] = BufferSpec(role="kv", heads="kv", positions=True, virtual=True)
    return ScheduleSpec(
        schedule=window_halo_schedule(halo),
        buffers=buffers,
        out=("p",),
        expected_kv=lambda P_, r: frozenset(((r - j) % P_, 0) for j in range(halo + 1)),
    )


def window_attention_sp(q, k, v, q_pos, k_pos, *, ring, window: int, causal: bool = True,
                        scale: float | None = None, impl: str = "auto", block_q: int = 512,
                        block_k: int = 512, block_q_bwd: int | None = None,
                        block_k_bwd: int | None = None, overlap: bool = True,
                        return_lse: bool = False):
    """Halo-exchange window attention on the local shards over the flat
    transport ``ring``."""
    S_loc = k.shape[1]
    halo = min(ring.size - 1, ceil_div(window - 1, S_loc))  # capped at P-1

    def flash(qq, qp, kk, vv, kp):
        return flash_attention(
            qq, kk, vv, q_pos=qp, k_pos=kp, causal=causal, window=window, scale=scale,
            impl=impl, block_q=block_q, block_k=block_k, block_q_bwd=block_q_bwd,
            block_k_bwd=block_k_bwd,
        )

    bufs = {"q": (q, q_pos), "kv0": (k, v, k_pos)}
    res = execute_schedule(window_halo_schedule(halo), bufs, ring=ring, compute_fn=flash,
                           overlap=overlap)
    out, lse = res["p"]
    return (out, lse) if return_lse else out


def window_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True, window=None,
                     S_kv=None, **_):
    """Halo fetch: ``ceil((W-1)/S_loc)`` predecessor (K, V) shards, one
    direction, independent of P once the halo is smaller than the ring."""
    S_loc = (S_kv or S) // P
    if not window:
        return CommCost(0.0, 0.0)
    halo = min(P - 1, ceil_div(window - 1, S_loc))
    kv = 2 * B * S_loc * Hkv * D * bytes_per_elem
    return CommCost(halo * kv, 0.0)


register_strategy(
    "window",
    window_attention_sp,
    comm_cost=window_comm_cost,
    schedule_spec=window_spec,
    supports_window=True,
    requires_window=True,
    requires_layout="contig",  # halo semantics assume contiguous shards
    hybrid_inner_ok=False,  # handles two axes itself through flat ring shifts
    pipelines=False,  # fetch-then-compute: the one flash waits for the halo
    extra_kwargs={"window"},  # the cost model needs the window size
    description="halo-exchange sliding-window attention (local layers)",
)

"""TokenRing sequence-parallel attention, the paper's contribution, §3.2
(copy of ``repro.core.token_ring``).

Both variants keep (K, V) **resident** on their home rank and circulate
queries plus flash-attention partials ``(block_out, block_lse)`` instead.
Both are step schedules (``core.schedule``) run by the double-buffered
executor, so every transfer is posted against data already in hand and
carries no dependency on the step's flash call.

``variant="faithful"`` — Algorithm 1 as written.  Q rotates ``+1`` per
  step; the partial computed at step ``i`` is sent *directly back* to the
  query's home rank ``(j - i) mod P``, one step late (during step ``i+1``'s
  flash), plus one drain hop after the last block.

``variant="bidir"`` (the default) — split-Q bidirectional co-rotation.  The
  local Q block is split in half; each half travels with its own ``(out,
  lse)`` accumulator, one half rotating ``+1`` and the other ``-1``, so both
  directions of every link are busy.  The accumulator lags its query by one
  rank: at step ``i`` the query is at rank ``home+i`` computing partial
  ``p_i`` while the accumulator (merged through ``p_{i-1}``) travels to
  ``home+i``; it arrives as the flash finishes and merges with ``p_i``.

Communication per device per direction (b = element size):
    faithful : fwd (P-1)*S*Hq*D*b (Q);  bwd sum_i i * S*(Hq*D+1)*b hop-bytes
    bidir    : (P-1) * (S/2)*(2*Hq*D+1)*b + final (S/2)*(Hq*D+1)*b (acc home)

Each Compute is one call of ``kernels.ops.flash_attention``: kernel A
forward, B1/B2 backward with the ``+ dlse`` term the merge's gradient feeds.
On the virtual ring the P ranks are folded into the batch dimension, so one
Compute is one launch of A over every rank.
"""

from __future__ import annotations

from functools import partial

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
    "token_ring_sp",
    "token_ring_bidir_schedule",
    "token_ring_bidir_spec",
    "token_ring_faithful_schedule",
    "token_ring_faithful_spec",
    "token_ring_comm_cost",
    "token_ring_faithful_comm_cost",
]


def token_ring_faithful_schedule(P: int) -> Schedule:
    """Algorithm 1, pipelined: Q rotates ``+1``; the partial computed at step
    ``i`` flies straight home (shift ``-i``) during step ``i+1``'s flash."""
    local = Step(Compute("q", ("kv",), "p"), Merge("acc", "p"))
    if P == 1:
        return Schedule(prologue=(local,))
    steps = [Step(Send(("q",), 1), Compute("q", ("kv",), "p"), Merge("acc", "p"))]
    for i in range(1, P):
        ops = []
        if i <= P - 2:
            ops.append(Send(("q",), 1))
        if i >= 2:
            # step i-1's partial (home = rank - (i-1)), in hand since last
            # step — its send shares the wire with this step's flash.
            ops.append(Send(("p",), -(i - 1), into=("ph",)))
        ops.append(Compute("q", ("kv",), "p"))
        if i >= 2:
            ops.append(Merge("acc", "ph"))
        steps.append(Step(*ops))
    drain = Step(Send(("p",), -(P - 1), into=("ph",)), Merge("acc", "ph"))
    return Schedule(prologue=(*steps, drain))


def token_ring_faithful_spec(P: int, **_) -> ScheduleSpec:
    """Analyzer model of the faithful schedule: the travelling partial ``p``
    priced at fp32 + lse with torus hop distances (the convention of
    :func:`token_ring_faithful_comm_cost`)."""
    return ScheduleSpec(
        schedule=token_ring_faithful_schedule(P),
        buffers={
            "q": BufferSpec(role="q", positions=True),
            "kv": BufferSpec(role="kv", heads="kv", positions=True),
            "acc": BufferSpec(role="acc", lse=True, bound_q="q"),
            "p": BufferSpec(role="acc", elem="f32", lse=True, virtual=True),
        },
        out=("acc",),
        torus_hops=True,
    )


def token_ring_bidir_schedule(P: int) -> Schedule:
    """Split-Q bidirectional co-rotation with the accumulator lagging its
    query by one rank.  Per half: ``P`` flash blocks, ``P-1`` query hops,
    ``P`` accumulator hops (``P-1`` pipelined + 1 going home)."""
    computes = (
        Compute("qa", ("kv",), "pa"),
        Compute("qb", ("kv",), "pb"),
        Merge("aa", "pa"),
        Merge("ab", "pb"),
    )
    if P == 1:
        return Schedule(prologue=(Step(*computes),))
    step0 = Step(Send(("qa",), 1), Send(("qb",), -1), *computes)
    body = Step(
        Send(("qa",), 1), Send(("aa",), 1),
        Send(("qb",), -1), Send(("ab",), -1),
        *computes,
    )
    last = Step(Send(("aa",), 1), Send(("ab",), -1), *computes)
    home = Step(Send(("aa",), 1), Send(("ab",), -1))
    return Schedule(
        prologue=(step0,), body=body, trips=P - 2, epilogue=(last, home),
        static=frozenset({"kv"}),
    )


def token_ring_bidir_spec(P: int, **_) -> ScheduleSpec:
    """Analyzer model of the bidir schedule: two half-Q streams, each with a
    lagging ``(out, lse)`` accumulator riding the same direction."""
    return ScheduleSpec(
        schedule=token_ring_bidir_schedule(P),
        buffers={
            "qa": BufferSpec(role="q", part=0, frac=0.5, positions=True),
            "qb": BufferSpec(role="q", part=1, frac=0.5, positions=True),
            "kv": BufferSpec(role="kv", heads="kv", positions=True),
            "aa": BufferSpec(role="acc", frac=0.5, elem="travel", lse=True, bound_q="qa"),
            "ab": BufferSpec(role="acc", frac=0.5, elem="travel", lse=True, bound_q="qb"),
        },
        out=("aa", "ab"),
    )


def _token_ring_faithful(q, k, v, q_pos, k_pos, *, ring, flash, overlap=True):
    """Algorithm 1: Q rotates +1; partials fly straight home (distance -i)."""
    bufs = {
        "q": (q, q_pos),
        "kv": (k, v, k_pos),
        "acc": empty_partial(q.shape, device=q.device),
    }
    out = execute_schedule(
        token_ring_faithful_schedule(ring.size), bufs, ring=ring,
        compute_fn=lambda qq, qp, kk, vv, kp: flash(qq, kk, vv, qp, kp), overlap=overlap,
    )
    return finalize(*out["acc"])


def _token_ring_bidir(q, k, v, q_pos, k_pos, *, ring, flash, travel_dtype=torch.float32,
                      overlap=True):
    """Split-Q bidirectional co-rotation.  ``travel_dtype``: wire format of
    the travelling ``out`` accumulator (bfloat16 halves its bytes at about
    1e-3 merge rounding; lse stays float32 either way)."""
    S = q.shape[1]
    require(check_even_split(
        S, what="Q block", who="token_ring variant='bidir'", alternative="variant='faithful'",
    ))
    half = S // 2
    qa, qb = q[:, :half], q[:, half:]
    qpa, qpb = q_pos[:, :half], q_pos[:, half:]
    bufs = {
        "qa": (qa, qpa),
        "qb": (qb, qpb),
        "kv": (k, v, k_pos),
        "aa": empty_partial(qa.shape, dtype=travel_dtype, device=q.device),
        "ab": empty_partial(qb.shape, dtype=travel_dtype, device=q.device),
    }
    out = execute_schedule(
        token_ring_bidir_schedule(ring.size), bufs, ring=ring,
        compute_fn=lambda qq, qp, kk, vv, kp: flash(qq, kk, vv, qp, kp), overlap=overlap,
    )
    oa, la = out["aa"]
    ob, lb = out["ab"]
    return finalize(torch.cat([oa, ob], dim=1), torch.cat([la, lb], dim=1))


def token_ring_sp(q, k, v, q_pos, k_pos, *, ring, variant: str = "bidir",
                  travel_dtype="float32", causal: bool = False, window: int | None = None,
                  scale: float | None = None, impl: str = "auto", block_q: int = 512,
                  block_k: int = 512, block_q_bwd: int | None = None,
                  block_k_bwd: int | None = None, overlap: bool = True,
                  return_lse: bool = False):
    """TokenRing SP attention on the local shards over the transport ``ring``."""

    def flash(qq, kk, vv, qp, kp):
        return flash_attention(
            qq, kk, vv, q_pos=qp, k_pos=kp, causal=causal, window=window, scale=scale,
            impl=impl, block_q=block_q, block_k=block_k, block_q_bwd=block_q_bwd,
            block_k_bwd=block_k_bwd,
        )

    if variant == "faithful":
        out, lse = _token_ring_faithful(q, k, v, q_pos, k_pos, ring=ring, flash=flash,
                                        overlap=overlap)
    elif variant == "bidir":
        dtype = getattr(torch, travel_dtype) if isinstance(travel_dtype, str) else travel_dtype
        out, lse = _token_ring_bidir(q, k, v, q_pos, k_pos, ring=ring, flash=flash,
                                     travel_dtype=dtype, overlap=overlap)
    else:
        raise ValueError(f"unknown token_ring variant: {variant!r}")
    return (out, lse) if return_lse else out


def token_ring_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True,
                         travel_dtype="float32", **_):
    """Split-Q bidirectional co-rotation, per device per direction:
    ``(P-1) * (S_loc/2) * (Q + out + lse)`` stepwise + the going-home hop.
    Q travels at ``bytes_per_elem``, the ``out`` accumulator at
    ``travel_dtype``, lse always float32."""
    if P <= 1:
        return CommCost(0.0, 0.0)
    S_loc = S // P
    q = B * S_loc * Hq * D * bytes_per_elem
    out = B * S_loc * Hq * D * itemsize(travel_dtype)
    lse = B * S_loc * Hq * LSE_BYTES
    per_dir = (P - 1) * (q + out + lse) / 2 + (out + lse) / 2
    return CommCost(per_dir, per_dir)


def token_ring_faithful_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True,
                                  **_):
    """Algorithm 1 on a torus: forward Q stream plus distance-``i`` homeward
    partial sends whose hop-bytes sum to ``O(P^2)`` (accumulator at fp32)."""
    S_loc = S // P
    q = B * S_loc * Hq * D * bytes_per_elem
    out_f32 = B * S_loc * Hq * D * 4
    lse = B * S_loc * Hq * LSE_BYTES
    hop_home = sum(i * (out_f32 + lse) for i in range(1, P))
    return CommCost((P - 1) * q, float(hop_home))


register_strategy(
    "tokenring",
    partial(token_ring_sp, variant="bidir"),
    comm_cost=token_ring_comm_cost,
    schedule_spec=token_ring_bidir_spec,
    kv_resident=True,
    extra_kwargs={"travel_dtype"},
    description="paper's method, TPU-adapted: split-Q bidirectional co-rotation",
)

register_strategy(
    "tokenring_faithful",
    partial(token_ring_sp, variant="faithful"),
    comm_cost=token_ring_faithful_comm_cost,
    schedule_spec=token_ring_faithful_spec,
    kv_resident=True,
    description="paper's Algorithm 1 literal schedule (far homeward sends)",
)

"""Hierarchical 2D TokenRing: intra-pod bidirectional ring x inter-pod
pipelined KV exchange (``"tokenring2d"``; copy of ``repro.core.hier2d``).

Flat rings price every hop alike; on a pod-structured fabric (NVLink inside,
PCIe/IB between — ``core.topology.two_pods``) that wastes the fast wires:
a flat bidirectional TokenRing pushes the *per-step* query+accumulator
stream over the slow inter-pod links on every lap (TASP's observation,
arXiv 2509.26541).  This schedule factorizes the P ranks into ``(pod,
inner)`` coordinates and splits the traffic by wire class:

  * **inner axis** — the paper's split-Q bidirectional co-rotation
    (``core.token_ring``) inside each pod; every lap but the last adds one
    extra query hop so q comes all the way home and consecutive laps
    compose: per direction, ``n_inner * (Q + out + lse)/2`` per composable
    lap and the flat lap's ``(n_inner-1) * Q/2 + n_inner * (out+lse)/2`` for
    the final one — all of it on intra-pod links;
  * **pod axis** — K/V rotates one pod per *super-step* into a ping-pong
    buffer (``kv0``/``kv1``), issued on the super-step's **first** inner step
    so the slow transfer has the whole inner lap (``n_inner + 1`` steps) to
    complete behind the flashes.

Total wire bytes per device per direction: ``n_pods x`` the inner lap on
intra links, plus ``(n_pods - 1) x (K + V)`` on inter links (forward only).
The cost model declares exactly that split via ``CommCost.links``, and the
ring transports count their sends in the same classes
(``core.collectives``: a pod-ring send is ``"inter"``, an inner-ring send
``"intra"``).

The schedule is fully unrolled (prologue-only): the pod exchange exists only
on the first step of a super-step, which cannot live in one uniform loop
body.  With a default ``2 x P/2`` factorization for even P (``1 x P`` —
plain bidir — for odd P), the registered spec/cost pair stays exactly
auditable at every ring size.  The runtime reaches the schedule only
through ``ParallelContext.plan(topology=...)``, as the reference does.
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
from repro_torch.core.strategies import (
    CommCost,
    LSE_BYTES,
    LinkCost,
    itemsize,
    register_strategy,
)
from repro_torch.kernels.ops import flash_attention

__all__ = [
    "hier2d_sp",
    "hier2d_schedule",
    "hier2d_spec",
    "hier2d_comm_cost",
    "default_pods",
]


def default_pods(P: int) -> int:
    """Factorization used when no topology pins one: two pods when the ring
    splits evenly, else a single pod (pure bidirectional TokenRing)."""
    return 2 if P > 1 and P % 2 == 0 else 1


def _inner_lap(kv: str, n_inner: int, *, final: bool) -> list[Step]:
    """One split-Q bidirectional lap (``token_ring_bidir_schedule`` with the
    Sends tagged ``axis="inner"`` and the KV buffer parametrized).

    A non-final lap rotates q on every stepping step so it makes a full
    ``n_inner``-hop circle: the lap's exit state is isomorphic to its entry
    state (q home, acc home) and laps compose across super-steps, at the
    price of one extra q hop per direction per lap.  The final lap is the
    flat schedule verbatim — q is abandoned one hop short of home once the
    accumulator is done with it.
    """
    computes = (
        Compute("qa", (kv,), "pa"),
        Compute("qb", (kv,), "pb"),
        Merge("aa", "pa"),
        Merge("ab", "pb"),
    )
    if n_inner == 1:
        return [Step(*computes)]
    qa_f = Send(("qa",), 1, axis="inner")
    qb_b = Send(("qb",), -1, axis="inner")
    aa_f = Send(("aa",), 1, axis="inner")
    ab_b = Send(("ab",), -1, axis="inner")
    step0 = Step(qa_f, qb_b, *computes)
    body = Step(qa_f, aa_f, qb_b, ab_b, *computes)
    home = Step(aa_f, ab_b)
    if final:
        last = Step(aa_f, ab_b, *computes)
        return [step0, *[body] * (n_inner - 2), last, home]
    return [step0, *[body] * (n_inner - 1), home]


def hier2d_schedule(n_pods: int, n_inner: int) -> Schedule:
    """``n_pods`` super-steps of an inner bidirectional lap; K/V ping-pongs
    ``kv0 -> kv1 -> kv0 ...`` one pod forward per super-step, the exchange
    riding the first inner step of each non-final super-step."""
    steps: list[Step] = []
    for j in range(n_pods):
        cur, nxt = f"kv{j % 2}", f"kv{(j + 1) % 2}"
        lap = _inner_lap(cur, n_inner, final=j == n_pods - 1)
        if j < n_pods - 1:
            pod_send = Send((cur,), 1, into=(nxt,), axis="pod")
            lap[0] = Step(pod_send, *lap[0].ops)
        steps.extend(lap)
    return Schedule(prologue=tuple(steps))


def hier2d_spec(P: int, *, n_pods: int | None = None, **_) -> ScheduleSpec:
    """Analyzer model: the bidir buffers plus the ping-pong KV pair, under a
    row-major ``(pod, inner)`` factorization of the P ranks."""
    np_ = n_pods if n_pods is not None else default_pods(P)
    if P % np_:
        raise ValueError(f"n_pods={np_} does not divide P={P}")
    ni = P // np_
    buffers = {
        "qa": BufferSpec(role="q", part=0, frac=0.5, positions=True),
        "qb": BufferSpec(role="q", part=1, frac=0.5, positions=True),
        "kv0": BufferSpec(role="kv", heads="kv", positions=True),
        "aa": BufferSpec(role="acc", frac=0.5, elem="travel", lse=True, bound_q="qa"),
        "ab": BufferSpec(role="acc", frac=0.5, elem="travel", lse=True, bound_q="qb"),
    }
    if np_ > 1:
        buffers["kv1"] = BufferSpec(role="kv", heads="kv", positions=True, virtual=True)
    return ScheduleSpec(
        schedule=hier2d_schedule(np_, ni),
        buffers=buffers,
        out=("aa", "ab"),
        axes=(("pod", np_), ("inner", ni)),
    )


def hier2d_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True,
                     travel_dtype="float32", n_pods=None, **_):
    """Per device: ``n_pods - 1`` composable inner laps
    (``n_inner * (q + out + lse)/2`` per direction) plus one final flat lap
    (``(n_inner - 1) * q/2 + n_inner * (out + lse)/2`` per direction) on
    intra links, plus ``(n_pods - 1) x (K + V)`` on inter links (forward
    only) — declared per class via ``CommCost.links``."""
    np_ = n_pods if n_pods is not None else default_pods(P)
    ni = P // np_
    S_loc = S // P
    q = B * S_loc * Hq * D * bytes_per_elem
    out = B * S_loc * Hq * D * itemsize(travel_dtype)
    lse = B * S_loc * Hq * LSE_BYTES
    if ni == 1:
        intra = 0.0
    else:
        lap_per_dir = ni * (q + out + lse) / 2
        final_per_dir = (ni - 1) * q / 2 + ni * (out + lse) / 2
        intra = (np_ - 1) * lap_per_dir + final_per_dir
    kv = 2 * B * S_loc * Hkv * D * bytes_per_elem
    inter = (np_ - 1) * kv
    return CommCost(
        intra + inter,
        intra,
        links=(LinkCost("intra", intra, intra), LinkCost("inter", inter, 0.0)),
    )


def hier2d_sp(q, k, v, q_pos, k_pos, *, ring, travel_dtype="float32", causal: bool = False,
              window: int | None = None, scale: float | None = None, impl: str = "auto",
              block_q: int = 512, block_k: int = 512, block_q_bwd: int | None = None,
              block_k_bwd: int | None = None, overlap: bool = True,
              return_lse: bool = False):
    """Hierarchical TokenRing over ``ring = (pod ring, inner ring)``, the
    two views of one ring's ``split`` (ranks row-major pod-then-inner)."""
    pod_ring, inner_ring = ring
    S = q.shape[1]
    require(check_even_split(S, what="Q block", who="tokenring2d",
                             alternative="an odd-P flat variant"))
    half = S // 2
    dtype = getattr(torch, travel_dtype) if isinstance(travel_dtype, str) else travel_dtype

    def flash(qq, qp, kk, vv, kp):
        return flash_attention(
            qq, kk, vv, q_pos=qp, k_pos=kp, causal=causal, window=window, scale=scale,
            impl=impl, block_q=block_q, block_k=block_k, block_q_bwd=block_q_bwd,
            block_k_bwd=block_k_bwd,
        )

    qa, qb = q[:, :half], q[:, half:]
    bufs = {
        "qa": (qa, q_pos[:, :half]),
        "qb": (qb, q_pos[:, half:]),
        "kv0": (k, v, k_pos),
        "aa": empty_partial(qa.shape, dtype=dtype, device=q.device),
        "ab": empty_partial(qb.shape, dtype=dtype, device=q.device),
    }
    out = execute_schedule(
        hier2d_schedule(pod_ring.size, inner_ring.size), bufs,
        ring={"pod": pod_ring, "inner": inner_ring}, compute_fn=flash, overlap=overlap,
    )
    oa, la = out["aa"]
    ob, lb = out["ab"]
    out, lse = finalize(torch.cat([oa, ob], dim=1), torch.cat([la, lb], dim=1))
    return (out, lse) if return_lse else out


register_strategy(
    "tokenring2d",
    hier2d_sp,
    comm_cost=hier2d_comm_cost,
    schedule_spec=hier2d_spec,
    auto_eligible=False,
    hybrid_inner_ok=False,
    ring_axes=2,
    extra_kwargs={"travel_dtype", "n_pods"},
    description=(
        "hierarchical 2D TokenRing: intra-pod bidirectional co-rotation x "
        "inter-pod pipelined KV exchange (planned via plan(topology=...))"
    ),
)

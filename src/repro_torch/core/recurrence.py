"""Sequence-parallel diagonal linear recurrences, the SSM substrate (port of
``repro.core.recurrence``).

TokenRing is an *attention* schedule; for the attention-free families the
sequence-parallel primitive is a distributed prefix scan of

    h_t = a_t * h_{t-1} + b_t          (elementwise / diagonal transition)

with the sequence sharded **contiguously** over the ring.  Three phases:

  1. a local inclusive scan (:func:`inclusive_scan`): a Hillis-Steele
     doubling on tensors, ``ceil(log2 S)`` rounds of a shifted
     :func:`_combine` along the time axis (the reference's
     ``lax.associative_scan``; the two round in another order, so float32
     results agree to about 1e-6 relative, not bitwise).  It gives each
     shard's outputs under a zero initial state and the shard's summary
     ``(A_prod, h_last)``;
  2. :func:`device_exclusive_scan` of the summaries *across ranks*:
     Hillis-Steele doubling over the ring's shifts of distance 1, 2, 4, ...
     then one exclusive shift of 1, the wrap masked by rank;
  3. a local fix-up ``h_t += A_cum_t * h_in`` from phase 1's cumulative
     products.

The cross-rank scan is written once against the transports' ``post(payload,
shift)`` (``core/collectives.py``): on the virtual ring the ranks are folded
into dim 0 of every buffer (rank ``r``'s rows ``[r*B, (r+1)*B)``) and the
rank mask is a per-rank-block tensor; on a process group the buffers are
this rank's and the mask its Python bool (as a 0-d tensor, see
:func:`_rank_mask`).  Rank order is the ring's flat
order, pod-major when the context has ``pods > 1`` (the reference's tuple
axis ``("pod", "model")``).  Gradients flow through the shifts' transposes
(a shift by ``-s``); nothing here reduces, so no forward-only collective is
on the path.

Bytes a rank hands the ring per scan (:func:`scan_comm_bytes`):
``ceil(log2 P) + 1`` shifts of the two summary tensors; the ledger charges
a distance-``s`` shift ``s`` neighbour hops (``core/collectives.py``), so
its ``link_bytes`` are the hop-weighted sum.  Each tensor is posted on its
own, so a backward transposes exactly the shifts whose results reach the
loss, on either transport: the state's every time, the decay product's in
every doubling round but the last (the last one's, and the exclusive
shift's, only compose the returned ``A``, which the callers drop).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "inclusive_scan",
    "local_linear_recurrence",
    "device_exclusive_scan",
    "chunked_linear_recurrence",
    "scan_comm_bytes",
]


def _combine(left, right):
    """Compose two (a, b) affine transforms: right after left."""
    a1, b1 = left
    a2, b2 = right
    return a1 * a2, a2 * b1 + b2


def inclusive_scan(a, b, axis: int = 1):
    """``(A_cum, h)`` of ``h_t = a_t h_{t-1} + b_t`` from a zero state along
    ``axis``: Hillis-Steele doubling, round ``d`` composes each step with
    the one ``d`` before it (steps before ``d`` keep their value)."""
    S = a.shape[axis]
    A, h = a, b
    d = 1
    while d < S:
        head = (A.narrow(axis, 0, d), h.narrow(axis, 0, d))
        newA, newh = _combine((A.narrow(axis, 0, S - d), h.narrow(axis, 0, S - d)),
                              (A.narrow(axis, d, S - d), h.narrow(axis, d, S - d)))
        A = torch.cat([head[0], newA], dim=axis)
        h = torch.cat([head[1], newh], dim=axis)
        d *= 2
    return A, h


def _last(x, axis):
    return x.select(axis, x.shape[axis] - 1)


def local_linear_recurrence(a, b, h0=None, axis: int = 1):
    """Single-device inclusive scan of ``h_t = a_t h_{t-1} + b_t``.

    ``a``/``b``: (..., S, ...state dims) with time on ``axis``.
    Returns ``(h, (A_prod, h_last))``.
    """
    A_cum, h = inclusive_scan(a, b, axis)
    if h0 is not None:
        h = h + A_cum * h0.unsqueeze(axis)
    return h, (_last(A_cum, axis), _last(h, axis))


def scan_comm_bytes(P: int, summary_bytes: int) -> dict:
    """Bytes one rank hands the ring in one :func:`device_exclusive_scan` of
    a summary whose two tensors hold ``summary_bytes`` bytes each, forward
    (``"fwd"``) and in the backward's transposes (``"bwd"``, when both
    tensors need gradients and only the state ``h_in`` is used):
    ``messages`` counts each shift once (forward: ``rounds = ceil(log2 P) +
    1`` shifts of both tensors; backward: the state's every shift, the decay
    product's but the last two), ``link_bytes`` as the ring's ledger charges
    them, a distance-s shift at s hops (the doubling's distances 1, 2, 4, ...
    and the final 1)."""
    if P == 1:
        zero = {"fwd": 0, "bwd": 0}
        return {"rounds": 0, "messages": zero, "link_bytes": dict(zero)}
    rounds = math.ceil(math.log2(P)) + 1
    hops, dist = 1, 1
    while dist < P:
        hops += dist
        dist *= 2
    last = dist // 2  # the last doubling round's distance
    return {"rounds": rounds,
            "messages": {"fwd": 2 * rounds * summary_bytes,
                         "bwd": (2 * rounds - 2) * summary_bytes},
            "link_bytes": {"fwd": 2 * hops * summary_bytes,
                           "bwd": (2 * hops - 1 - last) * summary_bytes}}


def _rank_mask(ring, rows: int, ndim: int, dist: int, device):
    """``rank >= dist`` of every rank's rows: a ``(rows, 1, ...)`` tensor of
    per-rank blocks on the virtual ring; on a process group the rank's
    Python bool as a 0-d tensor, so that a rank which selects the received
    value away still keeps it in its graph and runs the shift's transpose
    in the backward, as the rank it came from expects."""
    if not ring.folded:
        return torch.tensor(ring.rank >= dist, device=device)
    P = ring.size
    rank = torch.arange(P, device=device).repeat_interleave(rows // P)
    return (rank >= dist).reshape(rows, *([1] * (ndim - 1)))


def _shift(ring, tensors, dist: int):
    """Each tensor shifted by ``dist`` on ``ring``, posted on its own (see
    the module docstring) and waited."""
    return tuple(ring.post((t,), dist).wait()[0] for t in tensors)


def device_exclusive_scan(summary, ring):
    """Exclusive prefix-combine of the ranks' ``(A_prod, h_last)``
    summaries over ``ring``: rank ``r`` receives the composition of ranks
    ``0..r-1`` (the identity for rank 0).  Hillis-Steele doubling,
    ``ceil(log2 P)`` shift rounds, then one exclusive shift; the wrap of
    every shift is masked by rank."""
    A0, h0 = summary
    ident = (torch.ones_like(A0), torch.zeros_like(h0))
    P = ring.size
    if P == 1:
        return ident
    rows, ndim = A0.shape[0], A0.ndim
    incl = summary
    dist = 1
    while dist < P:
        recv = _shift(ring, incl, dist)
        combined = _combine(recv, incl)
        use = _rank_mask(ring, rows, ndim, dist, A0.device)
        incl = tuple(torch.where(use, c, o) for c, o in zip(combined, incl))
        dist *= 2
    excl = _shift(ring, incl, 1)
    use = _rank_mask(ring, rows, ndim, 1, A0.device)
    return tuple(torch.where(use, e, i) for e, i in zip(excl, ident))


def chunked_linear_recurrence(a, b, *, ring, axis: int = 1):
    """The sequence-parallel scan of this rank's contiguous shard (every
    rank's, folded into dim 0, on the virtual ring): ``h`` with the shape of
    ``b``."""
    A_cum, h_local = inclusive_scan(a, b, axis)
    if ring is None or ring.size == 1:
        return h_local
    _, h_in = device_exclusive_scan((_last(A_cum, axis), _last(h_local, axis)), ring)
    return h_local + A_cum * h_in.unsqueeze(axis)

"""Ring transports: the counterpart of ``repro.core.collectives``.

A ring of ``P`` ranks moves each rank's payload to rank ``(r + s) % P`` on a
shift by ``s`` (the reference's ``flat_ring_shift`` over one axis, one
``ppermute`` with :func:`ring_perm`).  Two transports implement it:

* :class:`VirtualRing` — the ``P`` ranks live in one process on one device,
  as a leading rank dimension folded into the batch dimension of every
  buffer: rows ``[r*B, (r+1)*B)`` of a ``(P*B, ...)`` tensor are rank
  ``r``'s.  A shift is two device-to-device copies of contiguous rank ranges
  into a fresh buffer (so generation g+1 never aliases generation g).  A
  posted shift on the card runs on the ring's own communication stream: it
  first waits for the compute stream (its payload is ready), every payload
  buffer gets ``record_stream`` (the caching allocator cannot reuse it under
  the copy), and the compute stream waits on the copy's event only when the
  receiver is read (:meth:`Pending.wait`), after the step's kernels are
  queued.  Kernels never run on the side stream.
* :class:`ProcessGroupRing` — one rank per process on a
  ``torch.distributed`` process group (gloo on the CPU, NCCL with one card
  per rank): each shift is one ``batch_isend_irecv`` that sends to
  ``(rank + s) % P`` and receives from ``(rank - s) % P``; a posted shift
  is waited after the step's computes.

Both are differentiable: the gradient of a shift by ``s`` is the shift of the
cotangent by ``-s`` (the transpose of ``ppermute`` that JAX's autodiff gives
the reference).  On the virtual ring the backward of a shift posted on the
side stream runs on the side stream (the autograd engine runs a node's
backward on its forward's stream and synchronises the streams around it).

Both also reduce (:meth:`VirtualRing.all_reduce`,
:meth:`ProcessGroupRing.all_reduce`): the serving paths' lse-weighted merge
(``core/decode.py``) is one ``max`` and one ``sum`` across the ranks.  The
all-reduce is forward only: serving never differentiates through it.

Both count what they are handed, per rank and per ring direction (``"fwd"``
for ``s > 0``, ``"bwd"`` for ``s < 0``), in the cost models' units: a
distance-``s`` send is charged ``|s|`` neighbour hops (the torus convention
of the schedule specs, which only TokenRing's faithful schedule uses), and
int32 position rows are counted apart, because the cost models leave them
out.  An all-reduce of a payload of ``n`` bytes a rank is charged what a
bidirectional ring all-reduce carries, ``(P-1)/P * n`` per rank in each
direction (the arithmetic of ``decode_comm_cost``).  Two-axis rings (the
reference's two-axis ``flat_ring_shift``) wait for ``core/hier2d.py``.
"""

from __future__ import annotations

import torch

__all__ = ["ring_perm", "Pending", "VirtualRing", "ProcessGroupRing", "HIER2D_ITEM",
           "fold_ranks", "unfold_ranks"]

HIER2D_ITEM = ("two-axis rings are not ported yet: they come with core/hier2d.py "
               "(ROADMAP queue 1 item 8)")


def ring_perm(P: int, shift: int):
    return [(r, (r + shift) % P) for r in range(P)]


def fold_ranks(x, P: int):
    """``(B, P*S, ...)`` global tensor -> ``(P*B, S, ...)`` with rank ``r``'s
    contiguous sequence shard in rows ``[r*B, (r+1)*B)``."""
    B, S = x.shape[0], x.shape[1] // P
    return x.reshape(B, P, S, *x.shape[2:]).transpose(0, 1).reshape(P * B, S, *x.shape[2:])


def unfold_ranks(x, P: int):
    """Inverse of :func:`fold_ranks`."""
    B, S = x.shape[0] // P, x.shape[1]
    return x.reshape(P, B, S, *x.shape[2:]).transpose(0, 1).reshape(B, P * S, *x.shape[2:])


class Pending:
    """The receivers of one posted shift; :meth:`wait` makes them readable
    on the compute stream and returns them."""

    def __init__(self, received, waits=()):
        self._received = received
        self._waits = list(waits)

    def wait(self):
        for w in self._waits:
            w()
        self._waits = []
        return self._received


class _Counters:
    """Bytes handed to a ring, per rank and direction (module docstring)."""

    def __init__(self):
        self.reset_counts()

    def reset_counts(self):
        self.link_bytes = {"fwd": 0.0, "bwd": 0.0}
        self.position_bytes = {"fwd": 0.0, "bwd": 0.0}

    def _count(self, tensors, shift: int, ranks: int):
        if shift % self.size == 0:
            return
        way = "fwd" if shift > 0 else "bwd"
        for t in tensors:
            nbytes = t.numel() * t.element_size() / ranks * abs(shift)
            kind = self.position_bytes if not t.is_floating_point() else self.link_bytes
            kind[way] += nbytes

    def _count_all_reduce(self, nbytes_per_rank: int):
        per_dir = (self.size - 1) / self.size * nbytes_per_rank
        self.link_bytes["fwd"] += per_dir
        self.link_bytes["bwd"] += per_dir


def _forward_only(x):
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the ring's all_reduce is forward only (serving does not "
                           "differentiate through it)")


_REDUCE_OPS = ("max", "sum")


def _flatten(payload):
    """Leaves of a payload of buffers (each a tensor or a tuple of tensors)
    and a function that rebuilds that structure from new leaves."""
    sizes = [len(b) if isinstance(b, tuple) else None for b in payload]
    leaves = [x for b in payload for x in (b if isinstance(b, tuple) else (b,))]

    def rebuild(new):
        out, i = [], 0
        for n in sizes:
            out.append(new[i] if n is None else tuple(new[i:i + n]))
            i += 1 if n is None else n
        return tuple(out)

    return leaves, rebuild


def _roll_ranks(x, P: int, shift: int):
    """Rank ``r``'s rows of ``x (P*B, ...)`` to rank ``(r + shift) % P``, in
    a fresh buffer: two copies of contiguous rank ranges."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    n = x.shape[0] // P * (shift % P)
    if n == 0:
        out.copy_(x)
    else:
        out[n:].copy_(x[:-n])
        out[:n].copy_(x[-n:])
    return out


class _VirtualShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, shift, reader):
        ctx.ring, ctx.shift, ctx.reader = ring, shift, reader
        return _roll_ranks(x, ring.size, shift)

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        ring._count((g,), -ctx.shift, ring.size)
        if ctx.reader is not None:  # ran on the side stream: keep g and the result alive
            g.record_stream(torch.cuda.current_stream(g.device))
        out = _roll_ranks(g, ring.size, -ctx.shift)
        if ctx.reader is not None:
            out.record_stream(ctx.reader)
        return out, None, None, None


class VirtualRing(_Counters):
    """``size`` ranks folded into the batch dimension of every buffer, on
    one device (see the module docstring)."""

    folded = True  # buffers hold every rank's rows

    def __init__(self, size: int, device="cuda"):
        super().__init__()
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self.size = size
        self.device = torch.device(device)
        self._stream = None

    def _side_stream(self):
        """The communication stream (made at first use on the card)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def _shift(self, x, shift, reader=None):
        if x.requires_grad:
            return _VirtualShift.apply(x, self, shift, reader)
        return _roll_ranks(x, self.size, shift)

    def post(self, payload, shift: int, *, overlap: bool = True) -> Pending:
        """Post one shift of every buffer of ``payload`` (a tuple of
        buffers, each a tensor or a tuple of tensors).  ``overlap=True`` on
        the card runs the copies on the side stream; otherwise they run on
        the current stream, in order."""
        leaves, rebuild = _flatten(payload)
        self._count(leaves, shift, self.size)
        if not (overlap and leaves[0].is_cuda):
            return Pending(rebuild([self._shift(x, shift) for x in leaves]))
        compute = torch.cuda.current_stream(leaves[0].device)
        side = self._side_stream()
        side.wait_stream(compute)
        with torch.cuda.stream(side):
            received = [self._shift(x, shift, compute) for x in leaves]
        for x in leaves:
            x.record_stream(side)
        for y in received:
            y.record_stream(compute)
        done = torch.cuda.Event()
        done.record(side)
        return Pending(rebuild(received), (lambda: compute.wait_event(done),))

    def rank_view(self, x):
        """``x (P*B, ...)`` as ``(P, B, ...)``: rank ``r``'s rows at ``[r]``."""
        return x.reshape(self.size, x.shape[0] // self.size, *x.shape[1:])

    def replicate(self, x):
        """A replicated tensor ``(B, ...)`` as every rank's copy, ``(P*B, ...)``."""
        return x.repeat(self.size, *([1] * (x.ndim - 1)))

    def all_reduce(self, x, op: str):
        """Reduce ``x (P*B, ...)`` over the ranks' row blocks with ``op``
        (``"max"`` or ``"sum"``), ranks 0..P-1 in order, on the current
        stream -> ``(B, ...)``, the value every rank holds afterwards.
        Forward only."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown reduction {op!r}; expected one of {_REDUCE_OPS}")
        _forward_only(x)
        parts = self.rank_view(x)
        self._count_all_reduce(parts[0].numel() * x.element_size())
        acc = parts[0].clone()
        for r in range(1, self.size):
            if op == "max":
                torch.maximum(acc, parts[r], out=acc)
            else:
                acc.add_(parts[r])
        return acc


class _PGShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, shift, works, *xs):
        ctx.ring, ctx.shift = ring, shift
        ctx.float_idx = [i for i, x in enumerate(xs) if x.is_floating_point()]
        received, posted = ring._exchange(xs, shift)
        works.extend(posted)
        ctx.mark_non_differentiable(*(y for y in received if not y.is_floating_point()))
        return received

    @staticmethod
    def backward(ctx, *gs):
        ring = ctx.ring
        grads = [gs[i] for i in ctx.float_idx]  # materialized: zeros where unused
        ring._count(grads, -ctx.shift, 1)
        received, posted = ring._exchange(grads, -ctx.shift)
        for w in posted:
            w.wait()
        out = [None] * len(gs)
        for i, y in zip(ctx.float_idx, received):
            out[i] = y
        return (None, None, None, *out)


class ProcessGroupRing(_Counters):
    """One rank per process on a ``torch.distributed`` process group (see
    the module docstring).  Every rank must post the same shifts in the same
    order: the n-th post of every rank is one logical shift, and its
    messages carry tags from that count (gloo matches on them; NCCL matches
    in order)."""

    folded = False  # buffers hold this rank's rows only

    def __init__(self, group=None):
        import torch.distributed as dist

        super().__init__()
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self._tag = 0

    def _peer(self, shift: int) -> tuple[int, int]:
        import torch.distributed as dist

        def glob(r):
            return dist.get_global_rank(self.group, r) if self.group is not dist.group.WORLD else r

        return glob((self.rank + shift) % self.size), glob((self.rank - shift) % self.size)

    def _exchange(self, xs, shift: int):
        """Post one batch of isend/irecv for ``xs``; returns ``(received,
        works)``.  A shift by a multiple of the size is a copy."""
        import torch.distributed as dist

        if shift % self.size == 0:
            return tuple(x.clone() for x in xs), []
        dst, src = self._peer(shift)
        ops, received = [], []
        for x in xs:
            x = x.contiguous()
            y = torch.empty_like(x)
            tag, self._tag = self._tag, self._tag + 1
            ops.append(dist.P2POp(dist.isend, x, dst, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, y, src, self.group, tag))
            received.append(y)
        return tuple(received), dist.batch_isend_irecv(ops)

    def post(self, payload, shift: int, *, overlap: bool = True) -> Pending:
        """Post one shift of ``payload`` (as :meth:`VirtualRing.post`);
        ``overlap=False`` waits at once."""
        leaves, rebuild = _flatten(payload)
        self._count(leaves, shift, 1)
        works: list = []
        if any(x.requires_grad for x in leaves):
            received = _PGShift.apply(self, shift, works, *leaves)
        else:
            received, posted = self._exchange(leaves, shift)
            works.extend(posted)
        pending = Pending(rebuild(list(received)), [w.wait for w in works])
        if not overlap:
            pending.wait()
        return pending

    def rank_view(self, x):
        """``x (B, ...)``, this rank's rows, as ``(1, B, ...)``."""
        return x[None]

    def replicate(self, x):
        """A replicated tensor is this rank's copy as it is."""
        return x

    def all_reduce(self, x, op: str):
        """``torch.distributed.all_reduce`` of this rank's ``x`` with ``op``
        (``"max"`` or ``"sum"``) into a new tensor: every rank gets the same
        result.  Forward only."""
        import torch.distributed as dist

        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown reduction {op!r}; expected one of {_REDUCE_OPS}")
        _forward_only(x)
        self._count_all_reduce(x.numel() * x.element_size())
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.group)
        return y

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

**Two axes.**  ``ring.split(pods)`` factors the ``P`` ranks row-major as
``(pod, inner)`` (rank ``r = pod * (P // pods) + inner``, the reference's
``flat_rank`` order) and returns two views of the same ranks: the pod ring
(``pods`` ranks, every inner index its own ring) and the inner ring
(``P // pods`` ranks, one ring per pod).  A shift on a view moves each
rank's payload along that axis only (``core.schedule.message_dst`` of an
axis-tagged ``Send``): on the virtual ring one copy of rank blocks in the
``(pod, inner)`` grid, on a process group a ``batch_isend_irecv`` over a
subgroup of the ranks that share the other coordinate.  The hierarchical
schedule (``core/hier2d.py``) posts on both views; the multi-pod hybrid
(``core/hybrid.py``) runs one executor on the pod ring inside whose computes
another runs on the inner ring.

**All-to-all and all-gather** (Ulysses, ``core/ulysses.py``): every
transport and view has :meth:`VirtualRing.all_to_all` (the reference's
tiled ``lax.all_to_all``: each rank cuts ``split_axis`` into ``P`` chunks,
chunk ``j`` goes to rank ``j``, which concatenates what it receives along
``concat_axis`` in rank order) and :meth:`VirtualRing.all_gather` (every
rank's tensor concatenated along an axis in rank order).  On the virtual
ring both are device-side reshapes and copies; on a process group
``dist.all_to_all_single`` and ``dist.all_gather``.  The all-to-all is
differentiable (its gradient is the inverse all-to-all, the transpose JAX's
autodiff gives); the all-gather is forward only (it gathers positions).

Both transports are differentiable: the gradient of a shift by ``s`` is the
shift of the cotangent by ``-s`` (the transpose of ``ppermute`` that JAX's
autodiff gives the reference).  On the virtual ring the backward of a shift
posted on the side stream runs on the side stream (the autograd engine runs
a node's backward on its forward's stream and synchronises the streams
around it).

Both also reduce (:meth:`VirtualRing.all_reduce`,
:meth:`ProcessGroupRing.all_reduce`): the serving paths' lse-weighted merge
(``core/decode.py``) is one ``max`` and one ``sum`` across the ranks, and
the MoE router loss (``models/moe.py``) averages its statistics over every
rank with a ``sum``.  The ``sum`` is differentiable: its backward is the
same sum all-reduce of the cotangent (the transpose JAX's autodiff gives
``psum``).  On the virtual ring the one result stands for every rank's
copy, so its cotangent already sums theirs and goes to every rank as it
is; on a process group each rank's copy has its own cotangent and the
backward sums them.  The ``max`` is forward only.  An axis view reduces
over its own axis: the result holds one block a ring of the other axis.

**The data axis.**  A mesh of ``D x P`` ranks (``launch/mesh.py``) adds a
data axis to the ring.  On the **virtual mesh** the model sees the global
batch, data-major (data rank ``d``'s rows ``[d*B/D, (d+1)*B/D)``), and the
ring folds its ``P`` ranks in front of it as above (``groups=D`` tells the
counters that each folded rank's rows hold ``D`` data ranks' rows), so a
shift stays within one data index.  On a **process group** of ``D x P``
ranks, :class:`ProcessGroupMeshComm` factors the transport as ``split``
does: the SP ring is the subgroup that shares a data index, the data view
the subgroup that shares a model index, both on one ledger.  The mesh
transports (:class:`VirtualMeshComm`, :class:`ProcessGroupMeshComm`) run
the FSDP storage's collectives (``repro_torch.sharding``): ``gather`` (an
all-gather of blocks), ``reduce_scatter`` (sum) and ``all_reduce`` (sum)
over any set of mesh axes, each charged to the ledger's ``"data"`` class:
an all-gather of a block of ``n`` bytes over ``G`` ranks ``(G-1) * n / 2``
a direction, a reduce-scatter of ``G * n`` bytes ``(G-1)/G * G * n / 2``,
an all-reduce of ``n`` bytes over ``A`` ranks ``(A-1)/A * n``.  Every full
tensor the FSDP gather hands out is held on the ledger until it is freed
(``weakref.finalize``: when the tensor itself dies, not its Python name),
and the ledger keeps the high-water of those bytes, ``gathered_high``:
what one rank of a real mesh holds at once beyond its blocks.

**Tensor parallelism** (serve storage, ``repro_torch.sharding``): both mesh
transports run the collectives of a weight split over ``model`` on
*ranked* activations, a tensor with a leading dim of this process's model
ranks (every one of them on the virtual mesh, this rank on a process
group), as the blocks of the weights are laid out: :meth:`tp_split` (this
process's slices of a replicated tensor, no traffic), :meth:`tp_gather`
(the activation all-gather: the ranks' slices concatenated in model
order) and :meth:`tp_sum` (the sum all-reduce), forward only.  They are
charged to the ledger's ``"tp"`` class, apart from the SP decode merge's
``"link"`` and the FSDP ``"data"``, at the conventions above: an
all-gather of a slice of ``n`` bytes ``(G-1) * n / 2`` a direction, an
all-reduce of ``n`` bytes ``(G-1)/G * n``; on the virtual mesh a slice
holds every data rank's rows, so it is charged ``1 / data_groups`` of its
bytes, one (data, model) rank's.  A serve leaf that a layer needs whole (a
norm scale) comes over :meth:`VirtualMeshComm.gather` on the same class.
On the pod mesh a recurrent decode state is split by its width over the
sequence axes ``("pod", "model")``, ``K = pods * G`` ways: :class:`SeqAxesTP`
runs the same three collectives over those ``K`` ranks (slices ranked
model-major, rank ``(p, m)``'s at ``m * pods + p``, so that each lies in
its model rank's weight block) and cuts a weight's model blocks into the
state's slices (:meth:`SeqAxesTP.sub_blocks`), on the same ledger class.

**What is counted.**  Every transport counts what it is handed, per rank and
per ring direction (``"fwd"`` for ``s > 0``, ``"bwd"`` for ``s < 0``), in
the cost models' units, in one ledger that a ring shares with its views:

* a distance-``s`` send is charged ``|s|`` neighbour hops (the torus
  convention of the schedule specs, which only TokenRing's faithful schedule
  uses) to ``link_bytes`` and to its link class in ``class_bytes``: a send
  on the pod ring is ``"inter"``, on the inner ring ``"intra"``, on the
  flat ring ``"link"`` (the classes of ``CommCost.links`` and
  ``CommCost.link_costs``);
* an all-to-all of a tensor of ``n`` bytes a rank is charged ``n / 2`` in
  each direction, as ``ulysses_comm_cost`` charges q, k, v and out;
* an all-reduce of ``n`` bytes a rank is charged what a bidirectional ring
  all-reduce carries, ``(P-1)/P * n`` in each direction (the arithmetic of
  ``decode_comm_cost``);
* integer tensors (position rows shifted or all-gathered, an all-gather
  of ``n`` bytes a rank at ``(P-1) * n / 2`` a direction; the expert-id
  and source-slot tables of the MoE exchange, all-to-all'd) go to
  ``position_bytes`` and the all-to-all of Ulysses' lse to ``lse_bytes``,
  apart, because the cost models leave them out.
"""

from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["ring_perm", "Pending", "VirtualRing", "ProcessGroupRing", "fold_ranks",
           "unfold_ranks", "VirtualMeshComm", "ProcessGroupMeshComm", "SeqAxesTP"]


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


def _zero():
    return {"fwd": 0.0, "bwd": 0.0}


class _Ledger:
    """Bytes handed to a ring and its views, per rank, and the FSDP gather's
    full tensors alive (module docstring).  :meth:`reset` zeroes the counts
    and restarts the high-water from the bytes alive now."""

    def __init__(self):
        self.gathered_live = 0
        self._lock = threading.Lock()  # a tensor may die on the autograd engine's thread
        self.reset()

    def reset(self):
        self.link_bytes, self.position_bytes, self.lse_bytes = _zero(), _zero(), _zero()
        self.class_bytes: dict[str, dict[str, float]] = {}
        self.gathered_high = self.gathered_live

    def add(self, cls: str, way: str, nbytes: float):
        self.link_bytes[way] += nbytes
        self.class_bytes.setdefault(cls, _zero())[way] += nbytes

    def hold(self, x):
        """Count ``x`` among the gathered bytes alive until it is freed."""
        n = x.numel() * x.element_size()
        with self._lock:
            self.gathered_live += n
            self.gathered_high = max(self.gathered_high, self.gathered_live)
        weakref.finalize(x, self._release, n)

    def _release(self, n):
        with self._lock:
            self.gathered_live -= n


class _Counters:
    """The counting side of a transport: ``link_class`` names its sends'
    class, ``folded_ranks`` how many ranks' rows one tensor holds, and
    ``data_groups`` how many data ranks' rows each of those holds (the
    virtual mesh: the ring's ranks see the whole batch)."""

    link_class = "link"
    folded_ranks = 1
    data_groups = 1

    @property
    def _counted_ranks(self):
        return self.folded_ranks * self.data_groups

    @property
    def link_bytes(self):
        return self.ledger.link_bytes

    @property
    def class_bytes(self):
        return self.ledger.class_bytes

    @property
    def position_bytes(self):
        return self.ledger.position_bytes

    @property
    def lse_bytes(self):
        return self.ledger.lse_bytes

    def reset_counts(self):
        self.ledger.reset()

    def _count(self, tensors, shift: int):
        if shift % self.size == 0:
            return
        way = "fwd" if shift > 0 else "bwd"
        for t in tensors:
            nbytes = t.numel() * t.element_size() / self._counted_ranks * abs(shift)
            if t.is_floating_point():
                self.ledger.add(self.link_class, way, nbytes)
            else:
                self.ledger.position_bytes[way] += nbytes

    def _count_all_reduce(self, nbytes_per_rank: int):
        per_dir = (self.size - 1) / self.size * nbytes_per_rank
        self.ledger.add(self.link_class, "fwd", per_dir)
        self.ledger.add(self.link_class, "bwd", per_dir)

    def _count_all_to_all(self, x, lse: bool):
        if self.size == 1:
            return
        half = x.numel() * x.element_size() / self._counted_ranks / 2
        for way in ("fwd", "bwd"):
            if lse:
                self.ledger.lse_bytes[way] += half
            elif x.is_floating_point():
                self.ledger.add(self.link_class, way, half)
            else:
                self.ledger.position_bytes[way] += half

    def _count_all_gather(self, x):
        per_dir = (self.size - 1) * x.numel() * x.element_size() / self._counted_ranks / 2
        for way in ("fwd", "bwd"):
            if x.is_floating_point():
                self.ledger.add(self.link_class, way, per_dir)
            else:
                self.ledger.position_bytes[way] += per_dir

    def all_to_all(self, x, split_axis: int, concat_axis: int, *, lse: bool = False):
        """The reference's tiled ``lax.all_to_all`` of this rank's ``x``
        (module docstring); differentiable.  ``lse=True`` counts the bytes
        apart, in ``lse_bytes``."""
        self._count_all_to_all(x, lse)
        if x.requires_grad:
            return _AllToAll.apply(x, self, split_axis, concat_axis, lse)
        return self._all_to_all(x, split_axis, concat_axis)

    def all_gather(self, x, axis: int):
        """Every rank's ``x`` concatenated along ``axis`` in rank order, on
        every rank.  Forward only."""
        _forward_only(x, "all_gather")
        self._count_all_gather(x)
        return self._all_gather(x, axis)

    def all_reduce(self, x, op: str):
        """Reduce ``x`` over the ranks with ``op`` (``"max"`` or ``"sum"``);
        the ``sum`` is differentiable (module docstring).  On the virtual
        ring ``x (P*B, ...)`` gives ``(B, ...)``, the value every rank holds
        afterwards (an axis view: ``(G*B, ...)``, one block a ring of the
        other axis); on a process group every rank gets the same result."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown reduction {op!r}; expected one of {_REDUCE_OPS}")
        if op == "sum" and torch.is_grad_enabled() and x.requires_grad:
            return _AllReduceSum.apply(x, self)
        _forward_only(x)
        return self._reduce(x, op)


def _forward_only(x, what="all_reduce"):
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"the ring's {what} is forward only")


_REDUCE_OPS = ("max", "sum")


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring._reduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.ring._reduce_transpose(g), None


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


def _a2a_ranked(v, n: int, split_axis: int, concat_axis: int):
    """The all-to-all of ``n`` ranks whose local tensors are ``v[r]`` (rank
    dimension first): rank ``j`` gets chunk ``j`` of every rank's
    ``split_axis``, concatenated along ``concat_axis`` in rank order."""
    w = v.unflatten(split_axis + 1, (n, v.shape[split_axis + 1] // n))
    w = w.movedim(split_axis + 1, 0)  # (dst, src, local...)
    return w.movedim(1, concat_axis + 1).flatten(concat_axis + 1, concat_axis + 2)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, split_axis, concat_axis, lse):
        ctx.ring, ctx.axes, ctx.lse = ring, (split_axis, concat_axis), lse
        return ring._all_to_all(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        ctx.ring._count_all_to_all(g, ctx.lse)
        return ctx.ring._all_to_all(g, concat_axis, split_axis), None, None, None, None


class _VirtualShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ring, shift, reader):
        ctx.ring, ctx.shift, ctx.reader = ring, shift, reader
        return ring._move(x, shift)

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        ring._count((g,), -ctx.shift)
        if ctx.reader is not None:  # ran on the side stream: keep g and the result alive
            g.record_stream(torch.cuda.current_stream(g.device))
        out = ring._move(g, -ctx.shift)
        if ctx.reader is not None:
            out.record_stream(ctx.reader)
        return out, None, None, None


class VirtualRing(_Counters):
    """``size`` ranks folded into the batch dimension of every buffer, on
    one device (see the module docstring)."""

    folded = True  # buffers hold every rank's rows
    # the (pod, inner) grid this ring moves along: the flat ring is one pod
    # whose inner axis holds every rank
    pods, axis = 1, 1

    def __init__(self, size: int, device="cuda", *, groups: int = 1, link_class: str = "link",
                 ledger=None):
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self.size = self.folded_ranks = size
        self.data_groups, self.link_class = groups, link_class
        self.device = torch.device(device)
        self.ledger = ledger if ledger is not None else _Ledger()
        self._stream = None
        self._splits = {}

    def _side_stream(self):
        """The communication stream (made at first use on the card)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def _move(self, x, shift):
        return _roll_ranks(x, self.size, shift)

    def _shift(self, x, shift, reader=None):
        if x.requires_grad:
            return _VirtualShift.apply(x, self, shift, reader)
        return self._move(x, shift)

    def post(self, payload, shift: int, *, overlap: bool = True) -> Pending:
        """Post one shift of every buffer of ``payload`` (a tuple of
        buffers, each a tensor or a tuple of tensors).  ``overlap=True`` on
        the card runs the copies on the side stream; otherwise they run on
        the current stream, in order."""
        leaves, rebuild = _flatten(payload)
        self._count(leaves, shift)
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

    def split(self, pods: int):
        """``(pod ring, inner ring)``: views of these ranks factored
        row-major as ``(pods, size // pods)`` (module docstring)."""
        if pods < 1 or self.size % pods:
            raise ValueError(f"{pods} pods do not divide a ring of {self.size} ranks")
        if pods not in self._splits:
            self._splits[pods] = (_VirtualAxisRing(self, pods, 0), _VirtualAxisRing(self, pods, 1))
        return self._splits[pods]

    def _by_axis(self, x):
        """``x (R*B, ...)`` (every rank's rows) -> ``(n, G*B, ...)``: this
        ring's ranks first, the ``G`` rings of the other axis in the batch."""
        R = self.folded_ranks
        g = x.reshape(self.pods, R // self.pods, x.shape[0] // R, *x.shape[1:])
        g = g.movedim(self.axis, 0)
        return g.reshape(self.size, -1, *x.shape[1:])

    def _from_axis(self, y):
        """Inverse of :meth:`_by_axis`."""
        R = self.folded_ranks
        g = y.reshape(self.size, R // self.size, -1, *y.shape[2:]).movedim(0, self.axis)
        return g.reshape(-1, *y.shape[2:])

    def _all_to_all(self, x, split_axis, concat_axis):
        return self._from_axis(_a2a_ranked(self._by_axis(x), self.size, split_axis,
                                           concat_axis))

    def _all_gather(self, x, axis):
        v = self._by_axis(x)
        whole = v.movedim(0, axis).flatten(axis, axis + 1)
        return self._from_axis(whole.expand(self.size, *whole.shape))

    def rank_view(self, x):
        """``x (P*B, ...)`` as ``(P, B, ...)``: rank ``r``'s rows at ``[r]``."""
        return x.reshape(self.size, x.shape[0] // self.size, *x.shape[1:])

    def replicate(self, x):
        """A replicated tensor ``(B, ...)`` as every rank's copy, ``(P*B, ...)``."""
        return x.repeat(self.size, *([1] * (x.ndim - 1)))

    def _reduce(self, x, op):
        """The ranks' row blocks of ``x`` reduced with ``op`` in rank order,
        on the current stream."""
        parts = self._by_axis(x)
        self._count_all_reduce(x.numel() * x.element_size() / self._counted_ranks)
        acc = parts[0].clone()
        for r in range(1, self.size):
            if op == "max":
                torch.maximum(acc, parts[r], out=acc)
            else:
                acc.add_(parts[r])
        return acc

    def _reduce_transpose(self, g):
        """The cotangent of the one shared result to every rank's rows."""
        self._count_all_reduce(g.numel() * self.size * g.element_size() / self._counted_ranks)
        return self._from_axis(g.expand(self.size, *g.shape))


class _VirtualAxisRing(VirtualRing):
    """One axis of a virtual ring's ``(pod, inner)`` grid (``axis`` 0: the
    pod ring, 1: the inner ring), on the parent's buffers, side stream and
    ledger."""

    def __init__(self, parent: VirtualRing, pods: int, axis: int):
        self.parent, self.pods, self.axis = parent, pods, axis
        self.size = pods if axis == 0 else parent.size // pods
        self.folded_ranks, self.data_groups = parent.size, parent.data_groups
        self.device, self.ledger = parent.device, parent.ledger
        self.link_class = ("inter", "intra")[axis]
        self._splits = {}

    def _side_stream(self):
        return self.parent._side_stream()

    def _move(self, x, shift):
        grid = x.reshape(self.pods, self.folded_ranks // self.pods, -1)
        return torch.roll(grid, shift, dims=self.axis).reshape(x.shape)

    def split(self, pods):
        raise ValueError("a ring's axis view does not split again")


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
        ring._count(grads, -ctx.shift)
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

    def __init__(self, group=None, *, ledger=None, link_class: str = "link"):
        import torch.distributed as dist

        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.ledger = ledger if ledger is not None else _Ledger()
        self.link_class = link_class
        self._tag = 0
        self._splits = {}

    def _global(self, r: int) -> int:
        import torch.distributed as dist

        return dist.get_global_rank(self.group, r) if self.group is not dist.group.WORLD else r

    def _peer(self, shift: int) -> tuple[int, int]:
        return (self._global((self.rank + shift) % self.size),
                self._global((self.rank - shift) % self.size))

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
        self._count(leaves, shift)
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

    def split(self, pods: int):
        """``(pod ring, inner ring)`` over subgroups of this group's ranks,
        factored row-major as ``(pods, size // pods)``.  Collective: every
        rank of the group calls it, with the same ``pods``, in the same
        order (it makes every subgroup)."""
        import torch.distributed as dist

        if pods < 1 or self.size % pods:
            raise ValueError(f"{pods} pods do not divide a ring of {self.size} ranks")
        if pods not in self._splits:
            n_in = self.size // pods
            ranks = [self._global(r) for r in range(self.size)]
            by_pod = [dist.new_group([ranks[p * n_in + i] for p in range(pods)])
                      for i in range(n_in)]
            by_inner = [dist.new_group(ranks[p * n_in:(p + 1) * n_in]) for p in range(pods)]
            pod, inner = divmod(self.rank, n_in)
            self._splits[pods] = (
                ProcessGroupRing(by_pod[inner], ledger=self.ledger, link_class="inter"),
                ProcessGroupRing(by_inner[pod], ledger=self.ledger, link_class="intra"))
        return self._splits[pods]

    def _all_to_all(self, x, split_axis, concat_axis):
        import torch.distributed as dist

        n = self.size
        wire = x.unflatten(split_axis, (n, x.shape[split_axis] // n)).movedim(split_axis, 0)
        wire = wire.contiguous()
        got = torch.empty_like(wire)
        dist.all_to_all_single(got, wire, group=self.group)
        return got.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)

    def _all_gather(self, x, axis):
        import torch.distributed as dist

        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=axis)

    def rank_view(self, x):
        """``x (B, ...)``, this rank's rows, as ``(1, B, ...)``."""
        return x[None]

    def replicate(self, x):
        """A replicated tensor is this rank's copy as it is."""
        return x

    def _reduce(self, x, op):
        """``torch.distributed.all_reduce`` of this rank's ``x`` with ``op``
        into a new tensor."""
        import torch.distributed as dist

        self._count_all_reduce(x.numel() * x.element_size())
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.group)
        return y

    def _reduce_transpose(self, g):
        """The ranks' cotangents summed: the same sum all-reduce."""
        return self._reduce(g, "sum")


class _MeshCounts:
    """The counting side of a mesh transport (module docstring, "The data
    axis"): every collective of the data-parallel layer is charged to the
    ledger's ``"data"`` class, per rank."""

    link_class = "data"
    tp_class = "tp"
    data_groups = 1

    def _axes_size(self, axes) -> int:
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n

    def _charge(self, per_dir: float, link_class: str | None = None):
        if per_dir:
            self.ledger.add(link_class or self.link_class, "fwd", per_dir)
            self.ledger.add(link_class or self.link_class, "bwd", per_dir)

    def _count_gather(self, blocks, axes, link_class=None):
        G = self._axes_size(axes)
        self._charge((G - 1) * blocks[0].numel() * blocks.element_size() / 2, link_class)

    @property
    def tp_size(self) -> int:
        return self.mesh.shape["model"]

    def _slice_bytes(self, parts) -> float:
        return parts[0].numel() * parts.element_size() / self.data_groups

    def _count_tp_gather(self, parts):
        self._charge((self.tp_size - 1) * self._slice_bytes(parts) / 2, self.tp_class)

    def _count_tp_sum(self, parts):
        G = self.tp_size
        self._charge((G - 1) / G * self._slice_bytes(parts), self.tp_class)

    def _count_reduce_scatter(self, full_blocks, axes):
        G = self._axes_size(axes)
        self._charge((G - 1) / G * full_blocks.numel() * full_blocks.element_size() / 2)

    def _count_all_reduce(self, blocks, axes):
        A = self._axes_size(axes)
        self._charge((A - 1) / A * blocks[0].numel() * blocks.element_size())

    def sub_blocks(self, blocks, dim: int):
        """A weight's ranked model blocks split along ``dim`` (of a block) as
        this transport's slices: the blocks themselves."""
        return blocks


class VirtualMeshComm(_MeshCounts):
    """The data-parallel collectives of a virtual mesh: every rank in this
    process.  A sharded leaf holds every distinct block, and the one full
    gradient of the step already sums every rank's (the batch holds every
    data rank's rows), so a gather, reduce-scatter or all-reduce moves
    nothing: it charges what each rank would send and returns its input."""

    folded = True
    rank = None

    def __init__(self, mesh, ledger=None, data_groups: int = 1):
        self.mesh = mesh
        self.ledger = ledger if ledger is not None else _Ledger()
        self.data_groups = data_groups

    def gather(self, blocks, axes, count: bool = True, link_class: str | None = None):
        """``(G, *block)`` blocks of the named group -> all of them."""
        if count:
            self._count_gather(blocks, axes, link_class)
        return blocks

    def tp_split(self, x, dim: int):
        """Every model rank's slice of a replicated ``x`` along ``dim``,
        ranked: ``(G, ...)``."""
        dim %= x.ndim
        return x.unflatten(dim, (self.tp_size, x.shape[dim] // self.tp_size)).movedim(dim, 0)

    def tp_gather(self, parts, dim: int):
        """The ranks' slices ``(G, ...)`` concatenated along ``dim`` (of a
        slice) in model order."""
        self._count_tp_gather(parts)
        dim %= parts.ndim - 1
        return parts.movedim(0, dim).flatten(dim, dim + 1)

    def tp_sum(self, parts):
        """The ranks' ``(G, ...)`` summed."""
        self._count_tp_sum(parts)
        return parts.sum(0)

    def tp_ranks(self, device):
        """The model coordinates of the ranked dim."""
        return torch.arange(self.tp_size, device=device)

    def reduce_scatter(self, full_blocks, axes):
        self._count_reduce_scatter(full_blocks, axes)
        return full_blocks

    def all_reduce(self, blocks, axes):
        self._count_all_reduce(blocks, axes)
        return blocks

    def world_sum(self, x):
        return x

    def owns(self, axes) -> bool:
        return True


class ProcessGroupMeshComm(_MeshCounts):
    """The data-parallel collectives of a ``torch.distributed`` group of
    ``mesh.size`` ranks, rank ``r`` at ``mesh.coords(r)``.  It makes a
    subgroup for every set of axes (the ranks that share the other
    coordinates) at construction, on every rank in the same order, so the
    views it hands out never call ``new_group`` on some ranks only.
    ``reduce_scatter`` is an all-reduce of which the rank keeps its block,
    which every backend has (gloo has no reduce-scatter); the ledger
    charges a reduce-scatter."""

    folded = False

    def __init__(self, mesh, group=None, *, ledger=None):
        import itertools

        import torch.distributed as dist

        self.mesh = mesh
        self.group = group if group is not None else dist.group.WORLD
        if dist.get_world_size(self.group) != mesh.size:
            raise ValueError(f"a group of {dist.get_world_size(self.group)} ranks cannot run a "
                             f"mesh of {mesh.size}")
        self.rank = dist.get_rank(self.group)
        self.ledger = ledger if ledger is not None else _Ledger()
        glob = [dist.get_global_rank(self.group, r) if self.group is not dist.group.WORLD else r
                for r in range(mesh.size)]
        self._groups = {}
        names = mesh.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                if n == len(names):
                    self._groups[axes] = self.group
                    continue
                seen = set()
                for r in range(mesh.size):
                    members = tuple(mesh.group(axes, r))
                    if members in seen:
                        continue
                    seen.add(members)
                    g = dist.new_group([glob[m] for m in members])
                    if self.rank in members:
                        self._groups[axes] = g

    def _key(self, axes):
        return tuple(a for a in self.mesh.axis_names if a in axes)

    def _pg(self, axes):
        return self._groups[self._key(axes)]

    def view(self, axes, link_class: str):
        """A :class:`ProcessGroupRing` over the ranks that share this rank's
        other coordinates, on this transport's ledger (``None`` for one
        rank)."""
        if self._axes_size(axes) == 1:
            return None
        return ProcessGroupRing(self._pg(axes), ledger=self.ledger, link_class=link_class)

    def gather(self, blocks, axes, count: bool = True, link_class: str | None = None):
        """This rank's ``(1, *block)`` -> the group's ``(G, *block)`` in
        row-major order over ``axes``."""
        import torch.distributed as dist

        if count:
            self._count_gather(blocks, axes, link_class)
        G = self._axes_size(axes)
        if G == 1:
            return blocks
        blocks = blocks.contiguous()
        parts = [torch.empty_like(blocks) for _ in range(G)]
        dist.all_gather(parts, blocks, group=self._pg(axes))
        return torch.cat(parts, dim=0)

    def reduce_scatter(self, full_blocks, axes):
        """``(G, *block)`` summed over the group; this rank's block kept."""
        import torch.distributed as dist

        self._count_reduce_scatter(full_blocks, axes)
        G = self._axes_size(axes)
        if G == 1:
            return full_blocks
        pg = self._pg(axes)
        y = full_blocks.contiguous().clone()
        dist.all_reduce(y, group=pg)
        i = dist.get_rank(pg)
        return y[i:i + 1].clone()

    def all_reduce(self, blocks, axes):
        import torch.distributed as dist

        self._count_all_reduce(blocks, axes)
        if self._axes_size(axes) == 1:
            return blocks
        y = blocks.contiguous().clone()
        dist.all_reduce(y, group=self._pg(axes))
        return y

    def _model_coord(self) -> int:
        return self.mesh.coords(self.rank)["model"]

    def tp_split(self, x, dim: int):
        """This rank's slice of a replicated ``x`` along ``dim``, ranked:
        ``(1, ...)``."""
        n = x.shape[dim] // self.tp_size
        return x.narrow(dim, self._model_coord() * n, n)[None]

    def tp_gather(self, parts, dim: int):
        """The model group's slices concatenated along ``dim`` (of a slice)
        in model order, from this rank's ``(1, ...)``."""
        import torch.distributed as dist

        self._count_tp_gather(parts)
        x = parts[0].contiguous()
        out = [torch.empty_like(x) for _ in range(self.tp_size)]
        dist.all_gather(out, x, group=self._pg(("model",)))
        return torch.cat(out, dim=dim)

    def tp_sum(self, parts):
        """This rank's ``(1, ...)`` summed over the model group."""
        import torch.distributed as dist

        self._count_tp_sum(parts)
        y = parts[0].contiguous().clone()
        dist.all_reduce(y, group=self._pg(("model",)))
        return y

    def tp_ranks(self, device):
        return torch.tensor([self._model_coord()], device=device)

    def world_sum(self, x):
        """A sum over every rank of the mesh, not counted (the step's
        scalars)."""
        import torch.distributed as dist

        y = x.detach().clone()
        dist.all_reduce(y, group=self.group)
        return y

    def owns(self, axes) -> bool:
        """Whether this rank is the first holder of its block of a leaf
        sharded over ``axes`` (coordinate 0 on every other axis): the one
        that counts it once."""
        c = self.mesh.coords(self.rank)
        return all(c[a] == 0 for a in self.mesh.axis_names if a not in axes)


class SeqAxesTP(_MeshCounts):
    """The tensor-parallel collectives of a decode state that the pod mesh
    splits by its width over its sequence axes ``("pod", "model")``, on the
    ``K = pods * G`` ranks of both (``comm`` the mesh's transport, whose
    ledger it charges; module docstring, "Tensor parallelism").  The
    slices are ranked model-major: rank ``(p, m)`` holds slice ``m * pods +
    p``, the ``p``-th part of model rank ``m``'s share, so every weight slice
    it needs lies in its own model block (:meth:`sub_blocks`).  A ranked
    tensor holds every slice in that order on the virtual mesh, this
    rank's on a process group."""

    def __init__(self, comm):
        self.comm, self.mesh, self.ledger = comm, comm.mesh, comm.ledger
        self.folded, self.data_groups = comm.folded, comm.data_groups
        self.pods = self.mesh.shape["pod"]

    @property
    def tp_size(self) -> int:
        return self.pods * self.mesh.shape["model"]

    def _coords(self):
        c = self.mesh.coords(self.comm.rank)
        return c["pod"], c["model"]

    def sub_blocks(self, blocks, dim: int):
        """A weight's ranked model blocks ``(G, ...)`` (this rank's ``(1,
        ...)``) split along ``dim`` (of a block) -> the state's slices
        ``(K, ...)`` (this rank's ``(1, ...)``): each block's ``pods``
        parts, in order."""
        dim = dim % (blocks.ndim - 1) + 1
        n = blocks.shape[dim] // self.pods
        if not self.folded:
            return blocks.narrow(dim, self._coords()[0] * n, n)
        return blocks.unflatten(dim, (self.pods, n)).movedim(dim, 1).flatten(0, 1)

    def tp_split(self, x, dim: int):
        """The ranks' slices of a replicated ``x`` along ``dim``, ranked."""
        dim %= x.ndim
        n = x.shape[dim] // self.tp_size
        if not self.folded:
            p, m = self._coords()
            return x.narrow(dim, (m * self.pods + p) * n, n)[None]
        return x.unflatten(dim, (self.tp_size, n)).movedim(dim, 0)

    def tp_gather(self, parts, dim: int):
        """The ranks' slices concatenated along ``dim`` (of a slice) in
        slice order: an all-gather over ``("pod", "model")``."""
        import torch.distributed as dist

        self._count_tp_gather(parts)
        if self.folded:
            dim %= parts.ndim - 1
            return parts.movedim(0, dim).flatten(dim, dim + 1)
        x = parts[0].contiguous()
        got = [torch.empty_like(x) for _ in range(self.tp_size)]
        dist.all_gather(got, x, group=self.comm._pg(("pod", "model")))
        G = self.mesh.shape["model"]  # the group ranks row-major: (p, m) at p * G + m
        return torch.cat([got[(j % self.pods) * G + j // self.pods]
                          for j in range(self.tp_size)], dim=dim)

    def tp_sum(self, parts):
        """The ranks' slices summed: an all-reduce over ``("pod", "model")``."""
        import torch.distributed as dist

        self._count_tp_sum(parts)
        if self.folded:
            return parts.sum(0)
        y = parts[0].contiguous().clone()
        dist.all_reduce(y, group=self.comm._pg(("pod", "model")))
        return y

"""SP step-schedule IR and the double-buffered overlap executor (copy of
``repro.core.schedule``; the executor runs eagerly on a ring transport of
``core.collectives``).

Every ring-style sequence-parallel schedule is the same loop wearing
different buffers: *ship something around the ring while computing a
flash-attention block against what is already here, then merge the
partial*.  A :class:`Schedule` holds per-step ops:

  * :class:`Send` — shift the named buffers ``shift`` places around the ring
    (the transport's ``post``).  The payload is read from the step's *entry*
    generation of the buffer, never from anything produced inside the step,
    so the transfer carries no data dependency on the step's compute.
  * :class:`Compute` — one flash-attention call: the query buffer against
    the concatenation of the named KV buffers, giving a mergeable
    ``(out, lse)`` partial.
  * :class:`Merge` — fold a partial into an accumulator with the paper's
    Update() equations (``core.merge.merge_partials``).

Step semantics (the double buffer):

  1. **snapshot** — all ``Send`` payloads and ``Compute`` reads see
     generation ``g``, the buffer contents at step entry;
  2. **commit** — ``Send`` receptions and ``Compute`` outputs land together
     as generation ``g+1`` (the validator rejects two ops writing one name);
  3. **merge** — ``Merge`` ops run on generation ``g+1``, so an accumulator
     rotated *this step* merges with the partial computed *this step*.

``execute_schedule(..., overlap=True)`` posts every Send of a step before
its Computes and waits for the receptions after them: on the card the
virtual ring's copies run on a side stream under the step's kernels, and a
process group's requests are in flight while the kernels run.
``overlap=False`` runs the Computes first and only then each Send, waited at
once on the compute stream.  Eager order is explicit, so both modes run the
same operations on the same values and give bitwise-equal results (the
reference needs an ``optimization_barrier`` tie for its sequential mode).

A schedule is ``prologue`` steps, an optional uniform ``body`` step repeated
``trips`` times (a Python loop here, ``lax.scan`` in the reference), and
``epilogue`` steps.  Buffers named in ``static`` stay out of the loop's
carry; the validator rejects a body that writes them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

__all__ = [
    "Send",
    "Compute",
    "Merge",
    "Step",
    "Schedule",
    "ScheduleError",
    "BufferSpec",
    "ScheduleSpec",
    "axis_extent",
    "ring_shift_hops",
    "message_dst",
    "message_route",
    "step_messages",
    "execute_schedule",
]


class ScheduleError(ValueError):
    """A malformed schedule: aliasing writes, unknown reads, bad body."""


@dataclass(frozen=True)
class Send:
    """Ring-shift ``buffers`` by ``shift``; receive into ``into`` (defaults
    to the same names, i.e. rotation in place).

    ``axis`` names which *logical ring axis* the shift moves on for
    hierarchical schedules (a ``ScheduleSpec.axes`` tag, e.g. ``"pod"`` /
    ``"inner"``); ``None`` means the flat ring of all P ranks.  The executor
    maps the tag to a mesh axis name through its ``axis_name`` mapping.
    """

    buffers: tuple[str, ...]
    shift: int
    into: tuple[str, ...] | None = None
    axis: str | None = None

    @property
    def targets(self) -> tuple[str, ...]:
        return self.into if self.into is not None else self.buffers


@dataclass(frozen=True)
class Compute:
    """Flash the ``q`` buffer (a ``(q, q_pos)`` pair) against the
    concatenation of the ``kv`` buffers (``(k, v, k_pos)`` triples), writing
    the ``(out, lse)`` partial to ``out``."""

    q: str
    kv: tuple[str, ...]
    out: str


@dataclass(frozen=True)
class Merge:
    """``dest = Update(dest, src)`` — online-softmax partial merge, applied
    after commit (so ``dest``/``src`` may be values received or computed in
    this very step)."""

    dest: str
    src: str


Op = Any  # Send | Compute | Merge


@dataclass(frozen=True)
class Step:
    ops: tuple[Op, ...]

    def __init__(self, *ops: Op):
        object.__setattr__(self, "ops", tuple(ops))

    @property
    def sends(self) -> tuple[Send, ...]:
        return tuple(o for o in self.ops if isinstance(o, Send))

    @property
    def computes(self) -> tuple[Compute, ...]:
        return tuple(o for o in self.ops if isinstance(o, Compute))

    @property
    def merges(self) -> tuple[Merge, ...]:
        return tuple(o for o in self.ops if isinstance(o, Merge))


@dataclass(frozen=True)
class Schedule:
    """``prologue`` / ``epilogue`` steps run unrolled; ``body`` runs ``trips``
    times in a loop.  ``static`` buffers never enter the scan carry."""

    prologue: tuple[Step, ...] = ()
    body: Step | None = None
    trips: int = 0
    epilogue: tuple[Step, ...] = ()
    static: frozenset[str] = field(default_factory=frozenset)

    def all_steps(self) -> tuple[Step, ...]:
        """The fully unrolled step sequence (analysis / IR-level tests)."""
        loop = (self.body,) * self.trips if self.body is not None else ()
        return (*self.prologue, *loop, *self.epilogue)

    def validate(self, initial: set[str]) -> None:
        """Raise :class:`ScheduleError` on aliasing writes, unknown reads, or
        a body that grows/renames the scan carry."""
        if self.trips and self.body is None:
            raise ScheduleError(f"trips={self.trips} with no body step")
        if self.trips < 0:
            raise ScheduleError(f"negative trips: {self.trips}")

        known = set(initial)

        def check_step(step: Step, where: str, *, in_body: bool) -> None:
            writes: list[str] = []
            for op in step.ops:
                if isinstance(op, Send):
                    if op.into is not None and len(op.into) != len(op.buffers):
                        raise ScheduleError(
                            f"{where}: Send into={op.into} does not match "
                            f"buffers={op.buffers}"
                        )
                    missing = [b for b in op.buffers if b not in known]
                    if missing:
                        raise ScheduleError(
                            f"{where}: Send reads unknown buffer(s) {missing}"
                        )
                    writes += list(op.targets)
                elif isinstance(op, Compute):
                    missing = [
                        b for b in (op.q, *op.kv) if b not in known
                    ]
                    if missing:
                        raise ScheduleError(
                            f"{where}: Compute reads unknown buffer(s) {missing}"
                        )
                    writes.append(op.out)
                elif isinstance(op, Merge):
                    pass  # merges read post-commit; checked below
                else:
                    raise ScheduleError(f"{where}: unknown op {op!r}")
            dup = {w for w in writes if writes.count(w) > 1}
            if dup:
                raise ScheduleError(
                    f"{where}: buffer generation would alias — {sorted(dup)} "
                    f"written more than once in one step (Send receptions and "
                    f"Compute outputs commit together)"
                )
            if in_body:
                new = [w for w in writes if w not in known]
                if new:
                    raise ScheduleError(
                        f"{where}: body introduces new buffer(s) {new} — the "
                        f"scan carry must be fixed; initialize them before "
                        f"the loop (prologue or initial buffers)"
                    )
                clash = [w for w in writes if w in self.static]
                if clash:
                    raise ScheduleError(
                        f"{where}: body writes static buffer(s) {clash}"
                    )
            known.update(writes)
            for op in step.merges:
                missing = [b for b in (op.dest, op.src) if b not in known]
                if missing:
                    raise ScheduleError(
                        f"{where}: Merge reads unknown buffer(s) {missing}"
                    )

        for i, step in enumerate(self.prologue):
            check_step(step, f"prologue[{i}]", in_body=False)
        if self.body is not None:
            check_step(self.body, "body", in_body=True)
        for i, step in enumerate(self.epilogue):
            check_step(step, f"epilogue[{i}]", in_body=False)


# ---------------------------------------------------------------------------
# Rank-symbolic walk hook (consumed by ``repro.analysis``)
#
# A Schedule is rank-agnostic SPMD: every rank runs the same ops, so a single
# Send op is really P point-to-point messages ``r -> (r + shift) % P``.
# ``step_messages`` materializes that view for one step, and the two spec
# dataclasses below let a strategy module declare, next to the schedule
# builder itself, what each buffer *is* (role, row fraction, wire dtype,
# sidecar rows) — everything the static checkers need to walk all P ranks and
# price every transfer without running or compiling anything.


@dataclass(frozen=True)
class BufferSpec:
    """Static description of one schedule buffer for rank-symbolic analysis.

    ``role``: ``"q"`` — a ``(q, q_pos)`` pair; ``"kv"`` — a ``(k, v, k_pos)``
    triple; ``"acc"`` — an ``(out, lse)`` partial/accumulator.
    ``part``: which split of the local shard this is (split-Q halves, split-KV
    halves); ``frac`` is the fraction of the local sequence rows it holds.
    ``heads``: ``"q"`` (Hq-sized) or ``"kv"`` (Hkv-sized).
    ``elem``: wire dtype of the payload tensor(s) — ``"input"`` (q/k/v dtype,
    the planner's ``bytes_per_elem``), ``"travel"`` (the ``travel_dtype``
    knob), or ``"f32"``.  Positions are always int32, lse always float32.
    ``bound_q``: for accumulators, the name of the query buffer whose partials
    this accumulator collects (coverage is checked against that query).
    ``virtual``: the buffer is *created by the schedule* (a Send ``into`` or a
    Compute output) rather than being part of the initial buffer dict — it is
    priced when sent but carries no initial value.
    """

    role: str
    part: int = 0
    frac: float = 1.0
    heads: str = "q"
    elem: str = "input"
    positions: bool = False  # an int32 position row travels with the payload
    lse: bool = False  # an fp32 lse row travels with the payload
    bound_q: str | None = None
    virtual: bool = False


@dataclass(frozen=True)
class ScheduleSpec:
    """A concrete :class:`Schedule` plus the buffer metadata the static
    analyzers (``repro.analysis``) need to symbolically execute it across all
    P ranks.  Strategy modules register a ``schedule_spec(P, **dims)`` factory
    returning one of these alongside their ``comm_cost`` model.

    ``out``: buffer names holding the final per-rank result, in local row
    order.  ``n_kv_parts``: how many KV splits circulate (bidirectional KV
    rings use 2).  ``torus_hops``: price a distance-``d`` send as ``d``
    neighbor-link traversals (TokenRing Algorithm 1 on a torus) instead of
    shortest-path hops.  ``expected_kv(P, rank)``: the exact set of
    ``(kv_home, kv_part)`` every output must cover — defaults to all parts of
    all ranks (full attention); windowed halo schedules override it.
    ``axes``: row-major ``((tag, size), ...)`` factorization of the P ranks
    for hierarchical schedules whose Sends carry axis tags — ``None`` means
    one flat ring of size P.  The product of sizes must equal P.
    """

    schedule: Schedule
    buffers: Mapping[str, BufferSpec]
    out: tuple[str, ...]
    n_kv_parts: int = 1
    torus_hops: bool = False
    expected_kv: Callable[[int, int], frozenset] | None = None
    axes: tuple[tuple[str, int], ...] | None = None

    def expected_coverage(self, P: int, rank: int) -> frozenset:
        if self.expected_kv is not None:
            return self.expected_kv(P, rank)
        return frozenset(
            (home, part) for home in range(P) for part in range(self.n_kv_parts)
        )


def axis_extent(
    axes: tuple[tuple[str, int], ...] | None, axis: str | None, P: int
) -> int:
    """Size of the logical ring a Send with tag ``axis`` moves on."""
    if axis is None or axes is None:
        if axes is not None:
            sizes = 1
            for _, n in axes:
                sizes *= n
            if sizes != P:
                raise ScheduleError(
                    f"axes {axes} do not factor P={P} (product {sizes})"
                )
        return P
    for tag, n in axes:
        if tag == axis:
            return n
    raise ScheduleError(f"Send axis {axis!r} not in declared axes {axes}")


def ring_shift_hops(shift: int, n: int, *, torus: bool = False):
    """``(hops, forward)`` of one shift on a ring of ``n`` ranks.

    Neighbor convention (matches ``launch.hlo_analysis.analyze_hlo``): a
    shift ``s`` (mod n) travels ``min(s, n-s)`` hops, forward iff
    ``s < n - s``; when both ways are equidistant (n=2, or ``s = n/2``) the
    declared sign decides.  ``torus=True`` prices a distance-``d`` send as
    ``d`` hops in the direction of its sign (TokenRing Algorithm 1).
    """
    if torus:
        return abs(shift), shift > 0
    s = shift % n if n > 0 else 0
    if s == 0:
        return 0, True
    hops = min(s, n - s)
    forward = s < n - s if s != n - s else shift > 0
    return hops, forward


def _rank_coords(rank: int, axes) -> list[int]:
    coords = []
    for _, n in reversed(axes):
        coords.append(rank % n)
        rank //= n
    coords.reverse()
    return coords


def _coords_rank(coords, axes) -> int:
    rank = 0
    for c, (_, n) in zip(coords, axes):
        rank = rank * n + c % n
    return rank


def message_dst(src: int, op: Send, P: int, axes=None) -> int:
    """Destination rank of one Send message: ``(src + shift) % P`` on the
    flat ring, or the shift applied to ``src``'s coordinate on ``op.axis``
    under the row-major ``axes`` factorization."""
    if op.axis is None or axes is None:
        return (src + op.shift) % P
    coords = _rank_coords(src, axes)
    for i, (tag, n) in enumerate(axes):
        if tag == op.axis:
            coords[i] = (coords[i] + op.shift) % n
            return _coords_rank(coords, axes)
    raise ScheduleError(f"Send axis {op.axis!r} not in declared axes {axes}")


def message_route(
    op: Send, src: int, P: int, axes=None, *, torus_hops: bool = False
) -> tuple[tuple[int, int], ...]:
    """The logical neighbor-hop path ``((u, v), ...)`` of one Send message:
    ``hops`` steps of ±1 along the op's ring, from ``src`` toward the
    destination (wrapping on that ring).  Physical mapping is the analyzer's
    job (``analysis.topo_check``) — this is pure logical-ring geometry."""
    n = axis_extent(axes, op.axis, P)
    hops, forward = ring_shift_hops(op.shift, n, torus=torus_hops)
    unit = 1 if forward else -1
    path = []
    cur = src
    one = Send(op.buffers, unit, axis=op.axis)
    for _ in range(hops):
        nxt = message_dst(cur, one, P, axes)
        path.append((cur, nxt))
        cur = nxt
    return tuple(path)


def step_messages(step: Step, P: int, axes=None):
    """All point-to-point messages of one SPMD step on a ring of ``P`` ranks.

    Yields ``(op, src, dst)`` for every Send op and source rank: the payload
    read on ``src`` lands in ``op.targets`` on ``dst`` — ``(src + shift) % P``
    on the flat ring, or the per-axis rotation under ``axes``.
    """
    for op in step.sends:
        for src in range(P):
            yield op, src, message_dst(src, op, P, axes)


def _run_step(step: Step, bufs: dict, *, ring, compute_fn: Callable, overlap: bool,
              shift_fn: Callable):
    from repro_torch.core.collectives import HIER2D_ITEM, Pending
    from repro_torch.core.merge import merge_partials

    snapshot = bufs  # generation g — never mutated below

    def post(op: Send):
        if op.axis is not None:
            raise NotImplementedError(HIER2D_ITEM)
        return shift_fn(tuple(snapshot[b] for b in op.buffers), ring, op.shift)

    def received(posted):
        return posted.wait() if isinstance(posted, Pending) else posted

    def run_compute(op: Compute):
        import torch

        q, q_pos = snapshot[op.q]
        ks, vs, kps = zip(*(snapshot[n] for n in op.kv))
        k = ks[0] if len(ks) == 1 else torch.cat(ks, dim=1)
        v = vs[0] if len(vs) == 1 else torch.cat(vs, dim=1)
        kp = kps[0] if len(kps) == 1 else torch.cat(kps, dim=1)
        return compute_fn(q, q_pos, k, v, kp)

    writes: dict[str, Any] = {}
    if overlap:
        # Pipelined: every send posted first, payloads straight off the
        # snapshot; the receptions are waited only after the computes.
        posted = [(op, post(op)) for op in step.sends]
        for op in step.computes:
            writes[op.out] = run_compute(op)
        for op, p in posted:
            writes.update(zip(op.targets, received(p)))
    else:
        # Sequential: compute first, then each send, done before the next.
        for op in step.computes:
            writes[op.out] = run_compute(op)
        for op in step.sends:
            writes.update(zip(op.targets, received(post(op))))

    out = dict(bufs)
    out.update(writes)  # commit — generation g+1
    for op in step.merges:
        o, l = out[op.dest]
        po, pl = out[op.src]
        out[op.dest] = merge_partials(o, l, po, pl)
    return out


def execute_schedule(schedule: Schedule, buffers: dict, *, ring, compute_fn: Callable,
                     overlap: bool = True, shift_fn: Callable | None = None) -> dict:
    """Run ``schedule`` over ``buffers`` (name -> tuple of tensors) on the
    ring transport ``ring``, returning the final buffer dict.

    ``compute_fn(q, q_pos, k, v, k_pos) -> (out, lse)`` is the block compute
    (a flash-attention closure).  ``shift_fn(payload, ring, shift)`` defaults
    to ``ring.post(payload, shift, overlap=overlap)`` and is injectable for
    device-free IR tests (it may return the received tuple itself).
    ``overlap=False`` runs each step's sends after its computes (see the
    module docstring) without changing any value.
    """
    schedule.validate(set(buffers))
    if shift_fn is None:
        def shift_fn(payload, ring, shift):
            return ring.post(payload, shift, overlap=overlap)
    bufs = dict(buffers)
    kw = dict(ring=ring, compute_fn=compute_fn, overlap=overlap, shift_fn=shift_fn)

    for step in schedule.prologue:
        bufs = _run_step(step, bufs, **kw)

    if schedule.body is not None and schedule.trips > 0:
        static = {n: bufs[n] for n in schedule.static if n in bufs}
        carry = {n: v for n, v in bufs.items() if n not in schedule.static}
        for _ in range(schedule.trips):
            nxt = _run_step(schedule.body, {**static, **carry}, **kw)
            carry = {n: nxt[n] for n in carry}
        bufs = {**static, **carry}

    for step in schedule.epilogue:
        bufs = _run_step(step, bufs, **kw)
    return bufs

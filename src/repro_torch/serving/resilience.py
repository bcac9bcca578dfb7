"""Serving-side resilience: fault injection, quarantine, audits, snapshots
(port of ``repro.serving.resilience``).

  * :class:`FaultPlan`: a deterministic, seedable injector threaded through
    the engine's named tick points (:data:`TICK_POINTS`).  Its Bernoulli
    draws come from ``np.random.default_rng(seed)`` as in the JAX plan, so
    both packages fire the same faults for one seed and one call sequence.
  * a typed fault hierarchy rooted at :class:`ServingFault`.  Faults that
    carry a ``uid`` are attributable: the engine quarantines and retries
    that one request (bounded exponential backoff) while the rest of the
    batch keeps decoding.  Unattributable faults cost their tick, and
    persistent faults climb the :class:`DegradeLadder`.
  * :class:`CacheAuditor`: an invariant sweep over the engine's paged state
    (block tables, allocator free list, prefix-index refcounts, lengths),
    run every N ticks and after every recovery; violations raise
    :class:`IntegrityError`, which restores the latest snapshot.
  * the snapshot sidecar (:func:`export_serving_state` /
    :func:`import_serving_state`): everything host-side the engine needs to
    resume in-flight requests token-exact.  Where the JAX sidecar stores a
    PRNG key, this one stores the state of the engine's ``torch.Generator``
    (so a restart at temperature > 0 stays token-exact) and the allocator's
    stripe counters.  The device pools ride through ``CheckpointManager``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "TICK_POINTS",
    "ServingFault",
    "InjectedFault",
    "IntegrityError",
    "LoadShedError",
    "FaultSpec",
    "FaultPlan",
    "DegradeLadder",
    "CacheAuditor",
    "export_serving_state",
    "import_serving_state",
]

#: Named engine tick points a :class:`FaultPlan` can fire at.  ``admit`` /
#: ``alloc`` / ``cow`` / ``sample`` calls carry the uid of the request being
#: served (attributable); ``evict`` carries the preemption victim's uid;
#: ``prefill_tick`` / ``decode_once`` fire at batch-step entry (engine-level).
TICK_POINTS = (
    "admit",
    "prefill_tick",
    "decode_once",
    "alloc",
    "evict",
    "cow",
    "sample",
)


class ServingFault(RuntimeError):
    """Base of every recoverable serving-runtime fault.

    ``uid`` attributes the fault to one request (the engine quarantines and
    retries it); ``None`` means engine-level (the tick is retried and the
    degrade ladder advances).  The engine's recovery machinery catches
    exactly this hierarchy — a real bug raising ``KeyError`` still surfaces.
    """

    def __init__(self, msg: str, *, uid: int | None = None):
        super().__init__(msg)
        self.uid = uid


class InjectedFault(ServingFault):
    """Raised by :meth:`FaultPlan.fire` — the test double for a dying
    device, poisoned request, or failed allocation at a named tick point."""

    def __init__(self, point: str, nth: int, *, uid: int | None = None):
        super().__init__(
            f"injected fault at {point}[{nth}]"
            + (f" (request {uid})" if uid is not None else ""),
            uid=uid,
        )
        self.point = point
        self.nth = nth


class IntegrityError(ServingFault):
    """The :class:`CacheAuditor` found the serving state inconsistent."""

    def __init__(self, violations):
        self.violations = list(violations)
        super().__init__(
            f"{len(self.violations)} cache invariant violation(s): "
            + "; ".join(self.violations)
        )


class LoadShedError(ServingFault):
    """Admission rejected: the degrade ladder is at its shedding rung."""


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire at the ``nth`` invocation of ``point``
    (per-point counters, 0-based), ``times`` consecutive invocations long.

    With ``uid`` set, only invocations attributed to that request count and
    fire — e.g. ``FaultSpec("sample", nth=0, uid=3, times=2)`` kills request
    3's first two sampling attempts, exercising two quarantine/backoff
    rounds before it succeeds.
    """

    point: str
    nth: int = 0
    times: int = 1
    uid: int | None = None

    def __post_init__(self):
        if self.point not in TICK_POINTS:
            raise ValueError(
                f"unknown tick point {self.point!r}; expected one of {TICK_POINTS}"
            )
        if self.nth < 0 or self.times < 1:
            raise ValueError(f"need nth >= 0 and times >= 1, got {self}")


class FaultPlan:
    """Deterministic injector over the engine's named tick points.

    Two firing modes, composable:

      * **scheduled** — a list of :class:`FaultSpec`; each fires on exact
        invocation counts, so a chaos test pins "the 3rd decode step dies"
        and CI replays it.
      * **rate-based** — :meth:`bernoulli`: every invocation of the chosen
        points fails independently with probability ``rate``, drawn from a
        seeded generator.  For a fixed workload the call sequence (and so
        the fired set) is fully reproducible from the seed.

    ``fired`` records every fault raised as ``(point, nth, uid)``.
    """

    def __init__(self, faults=(), *, rate: float = 0.0, seed: int = 0,
                 points=TICK_POINTS):
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"rate must be in [0, 1), got {rate}")
        for p in points:
            if p not in TICK_POINTS:
                raise ValueError(f"unknown tick point {p!r}")
        self.faults = [
            f if isinstance(f, FaultSpec) else FaultSpec(*f) for f in faults
        ]
        self.rate = rate
        self.points = tuple(points)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._counts: dict[tuple, int] = {}
        self.fired: list[tuple[str, int, int | None]] = []

    @classmethod
    def bernoulli(cls, rate: float, *, seed: int = 0, points=TICK_POINTS):
        """Every invocation of ``points`` fails with probability ``rate``."""
        return cls((), rate=rate, seed=seed, points=points)

    def _count(self, key) -> int:
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        return n

    def fire(self, point: str, *, uid: int | None = None) -> None:
        """Count this invocation of ``point`` and raise
        :class:`InjectedFault` if the plan schedules a fault here."""
        n = self._count(point)
        hit = any(
            f.point == point and f.uid is None and f.nth <= n < f.nth + f.times
            for f in self.faults
        )
        if uid is not None:
            n_uid = self._count((point, uid))
            hit = hit or any(
                f.point == point and f.uid == uid
                and f.nth <= n_uid < f.nth + f.times
                for f in self.faults
            )
        if self.rate and point in self.points:
            hit = hit or bool(self._rng.random() < self.rate)
        if hit:
            self.fired.append((point, n, uid))
            raise InjectedFault(point, n, uid=uid)


# ---------------------------------------------------------------------------
# degrade ladder
# ---------------------------------------------------------------------------


class DegradeLadder:
    """Graceful degradation under persistent faults, one rung at a time.

    Rungs (:data:`LEVELS`):

      0. ``normal`` — full feature set.
      1. ``no_splice`` — prefix-cache *splicing* disabled: admissions stop
         mapping resident shared pages (no lookup/acquire/COW); completed
         prefills still register, so the index keeps learning.
      2. ``no_share`` — the dense-style fallback: all cross-request page
         sharing off (no lookup *and* no register) — every request owns
         private pages only, exactly the dense slab's ownership discipline.
      3. ``shed`` — new admissions are rejected (``submit`` raises
         :class:`LoadShedError`; queued requests wait) while in-flight and
         retrying requests drain.

    Escalation: ``escalate_after`` faults within a ``window``-tick span climb
    one rung (and reset the count).  De-escalation: ``cooldown`` consecutive
    fault-free ticks step back down one rung at a time — the ladder is
    self-healing, never latched.
    """

    LEVELS = ("normal", "no_splice", "no_share", "shed")

    def __init__(self, *, escalate_after: int = 3, window: int = 16,
                 cooldown: int = 48):
        if escalate_after < 1 or window < 1 or cooldown < 1:
            raise ValueError("escalate_after, window, cooldown must be >= 1")
        self.escalate_after = escalate_after
        self.window = window
        self.cooldown = cooldown
        self.level = 0
        self.escalations = 0
        self._faults: deque[int] = deque()
        self._last_fault = -1

    @property
    def name(self) -> str:
        return self.LEVELS[self.level]

    @property
    def allow_splice(self) -> bool:
        return self.level < 1

    @property
    def allow_share(self) -> bool:
        return self.level < 2

    @property
    def allow_admission(self) -> bool:
        return self.level < 3

    def record_fault(self, tick: int) -> None:
        self._last_fault = tick
        self._faults.append(tick)
        while self._faults and self._faults[0] <= tick - self.window:
            self._faults.popleft()
        if (
            len(self._faults) >= self.escalate_after
            and self.level < len(self.LEVELS) - 1
        ):
            self.level += 1
            self.escalations += 1
            self._faults.clear()

    def record_clean(self, tick: int) -> None:
        if (
            self.level > 0
            and self._last_fault >= 0
            and tick - self._last_fault >= self.cooldown
        ):
            self.level -= 1
            # a further step-down needs another full fault-free cooldown
            self._last_fault = tick

    # -- snapshot round-trip ------------------------------------------------

    def export_state(self) -> dict:
        return {
            "level": self.level,
            "escalations": self.escalations,
            "last_fault": self._last_fault,
            "faults": list(self._faults),
            "escalate_after": self.escalate_after,
            "window": self.window,
            "cooldown": self.cooldown,
        }

    def load_state(self, blob: dict) -> None:
        self.level = int(blob["level"])
        self.escalations = int(blob["escalations"])
        self._last_fault = int(blob["last_fault"])
        self._faults = deque(int(t) for t in blob["faults"])


# ---------------------------------------------------------------------------
# runtime cache auditor
# ---------------------------------------------------------------------------


@dataclass
class CacheAuditor:
    """Invariant sweep over a :class:`~repro_torch.serving.engine.ServingEngine`.

    Cheap enough to run every N ticks and after every recovery (host-side
    bookkeeping plus one ``len`` fetch).  Checked invariants, each with a
    typed violation code:

      * ``BT-RANGE`` — every mapped block-table entry is a valid page id.
      * ``BT-GAP`` — mapped entries form a contiguous prefix of their row
        (the engine maps pages strictly in logical order).
      * ``BT-ALIAS`` — a private (non-index-owned) page is mapped by at most
        one slot; only prefix-index pages may be shared.
      * ``FREE-MAPPED`` / ``FREE-INDEXED`` — the allocator's free list is
        disjoint from every mapped page and every index-owned page (a slot
        must never reference a freed page).
      * ``REF-MISMATCH`` — each index page's refcount equals the number of
        slots observed mapping it.
      * ``ACCOUNT`` — allocator in-use count equals the pages actually held
        (mapped private + index-owned residents).
      * ``LEN-MISMATCH`` — each occupied slot's device-side cache length
        equals the engine's host-side ``_cached`` progress counter.
      * ``SLOT-EMPTY`` — an unoccupied slot's block-table row is fully
        unmapped.
    """

    engine: object
    last: list = field(default_factory=list)

    def violations(self) -> list[str]:
        eng = self.engine
        out: list[str] = []
        lens = eng.state["len"].cpu().numpy()
        for i, req in enumerate(eng.slots):
            if req is None:
                continue
            cached = int(getattr(req, "_cached", 0))
            if int(lens[i]) != cached:
                out.append(
                    f"LEN-MISMATCH: slot {i} (request {req.uid}) device len "
                    f"{int(lens[i])} != host progress {cached}"
                )
        if not eng._paged:
            self.last = out
            return out

        n_pages, null = eng.max_pages, eng.NULL
        free = set(eng.alloc.free_set)
        index_pages = eng.prefix.pages if eng.prefix is not None else set()
        sharers: dict[int, int] = {}
        mapped: set[int] = set()
        for i in range(eng.max_batch):
            row = eng._bt[i]
            ended = False
            for w, p in enumerate(int(p) for p in row):
                if p == null:
                    ended = True
                    continue
                if not 0 <= p < n_pages:
                    out.append(f"BT-RANGE: slot {i} entry {w} = {p}")
                    continue
                if ended:
                    out.append(
                        f"BT-GAP: slot {i} entry {w} mapped after an "
                        "unmapped entry"
                    )
                sharers[p] = sharers.get(p, 0) + 1
                mapped.add(p)
            if eng.slots[i] is None and any(int(p) != null for p in row):
                out.append(f"SLOT-EMPTY: slot {i} is free but maps pages")
        for p, n in sharers.items():
            if p not in index_pages and n > 1:
                out.append(f"BT-ALIAS: private page {p} mapped by {n} slots")
        for p in sorted(mapped & free):
            out.append(f"FREE-MAPPED: page {p} is mapped and on the free list")
        for p in sorted(index_pages & free):
            out.append(f"FREE-INDEXED: page {p} is indexed and on the free list")
        if eng.prefix is not None:
            for p in sorted(index_pages):
                want = sharers.get(p, 0)
                got = eng.prefix.refcount(p)
                if got != want:
                    out.append(
                        f"REF-MISMATCH: page {p} refcount {got} != "
                        f"{want} observed sharer(s)"
                    )
        held = mapped | index_pages
        if eng.alloc.pages_in_use != len(held):
            out.append(
                f"ACCOUNT: allocator reports {eng.alloc.pages_in_use} pages "
                f"in use, engine holds {len(held)}"
            )
        self.last = out
        return out

    def check(self) -> None:
        v = self.violations()
        if v:
            raise IntegrityError(v)


# ---------------------------------------------------------------------------
# serving-state snapshot sidecar (JSON-safe host state)
# ---------------------------------------------------------------------------


def _request_record(req) -> dict:
    return {
        "uid": req.uid,
        "prompt": np.asarray(req.prompt).tolist(),
        "max_new_tokens": req.max_new_tokens,
        "eos_id": req.eos_id,
        "output": list(req.output),
        "stopped_eos": bool(req.stopped_eos),
        "status": req.status,
        "retries": req.retries,
        "error": req.error,
        "tokens": np.asarray(req._tokens).tolist(),
        "pages": [int(p) for p in getattr(req, "_pages", [])],
        "filled": int(getattr(req, "_filled", 0)),
        "cached": int(getattr(req, "_cached", 0)),
        "next_token": getattr(req, "_next_token", None),
        "ready_tick": int(getattr(req, "_ready_tick", 0)),
        "t_submit": req.t_submit,
        "t_first": req.t_first,
        "t_done": req.t_done,
    }


def _request_from(rec: dict):
    from repro_torch.serving.engine import Request

    req = Request(
        uid=int(rec["uid"]),
        prompt=np.asarray(rec["prompt"], np.int32),
        max_new_tokens=int(rec["max_new_tokens"]),
        eos_id=rec["eos_id"],
    )
    req.output = list(rec["output"])
    req.stopped_eos = bool(rec["stopped_eos"])
    req.status = rec["status"]
    req.retries = int(rec["retries"])
    req.error = rec["error"]
    req._tokens = np.asarray(rec["tokens"], np.int32)
    req._pages = [int(p) for p in rec["pages"]]
    req._filled = int(rec["filled"])
    req._cached = int(rec["cached"])
    if rec["next_token"] is not None:
        req._next_token = int(rec["next_token"])
    req._ready_tick = int(rec["ready_tick"])
    req.t_submit = rec["t_submit"]
    req.t_first = rec["t_first"]
    req.t_done = rec["t_done"]
    return req


def export_serving_state(eng) -> dict:
    """The engine's complete host-side serving state as a JSON-safe dict.

    Together with the device pools saved by ``CheckpointManager`` this is
    sufficient to resume every in-flight request token-exact: block tables,
    allocator free list + high-water, prefix-index chain keys/refcounts,
    the scheduler queue (FCFS order preserved), per-slot request progress,
    counters, ladder state, and the sampling generator's state.
    """
    blob = {
        "config": {
            "max_batch": eng.max_batch,
            "max_len": eng.max_len,
            "temperature": eng.temperature,
            "prefill_chunk": eng.prefill_chunk,
            "token_budget": eng.token_budget,
            "page_size": eng.page_size,
            "max_pages": eng.max_pages if eng._paged else None,
            "preempt": eng.preempt,
            "prefix_cache": eng.prefix is not None,
            "audit_every": eng.audit_every,
            "max_retries": eng.max_retries,
            "retry_backoff": eng.retry_backoff,
            "snapshot_every": eng.snapshot_every,
        },
        "tick": eng._tick,
        "uid": eng._uid,
        "generator": eng.gen.get_state().tolist(),
        "counters": dict(eng.counters),
        "ladder": eng.ladder.export_state(),
        "hold_decode": sorted(eng._hold_decode),
        "slots": [
            None if r is None else _request_record(r) for r in eng.slots
        ],
        "queue": [_request_record(r) for r in eng.queue],
        "done": [_request_record(r) for r in eng.done],
    }
    if eng._paged:
        blob["block_tables"] = eng._bt.tolist()
        blob["allocator"] = {
            "free": [int(p) for p in eng.alloc._free],
            "high_water": eng.alloc.high_water,
            "in_stripe": list(eng.alloc._in_stripe),
            "stripes_at_high_water": list(eng.alloc.stripes_at_high_water),
        }
        if eng.prefix is not None:
            blob["prefix"] = eng.prefix.export_state()
    return blob


def import_serving_state(eng, blob: dict) -> None:
    """Rehydrate ``eng``'s host-side state from :func:`export_serving_state`.

    The device pools must already have been restored (the engine re-syncs
    block tables from the sidecar's host copy on the next step).  Request
    objects are rebuilt — references returned by the pre-kill ``submit``
    calls do not track the restored engine.
    """
    import torch

    cfg = blob["config"]
    for knob in ("max_batch", "page_size", "prefill_chunk"):
        if cfg[knob] != getattr(eng, knob):
            raise ValueError(
                f"snapshot was taken with {knob}={cfg[knob]}, engine has "
                f"{getattr(eng, knob)}"
            )
    eng._tick = int(blob["tick"])
    eng._uid = int(blob["uid"])
    eng.gen.set_state(torch.tensor(blob["generator"], dtype=torch.uint8))
    for k, v in blob["counters"].items():
        # Counters are monotone: a kill-and-restart engine (all zeros) takes
        # the saved values, while an in-process snapshot-restore keeps the
        # faults/recoveries it counted *after* the snapshot was taken.
        eng.counters[k] = max(int(v), eng.counters.get(k, 0))
    eng.ladder.load_state(blob["ladder"])
    eng._hold_decode = set(blob["hold_decode"])
    eng.slots = [
        None if r is None else _request_from(r) for r in blob["slots"]
    ]
    eng.queue = [_request_from(r) for r in blob["queue"]]
    eng.done = [_request_from(r) for r in blob["done"]]
    if eng._paged:
        eng._bt = np.asarray(blob["block_tables"], np.int32)
        eng._bt_dirty = True
        free = [int(p) for p in blob["allocator"]["free"]]
        eng.alloc._free = list(free)
        eng.alloc._free_set = set(free)
        eng.alloc.high_water = int(blob["allocator"]["high_water"])
        eng.alloc._in_stripe = [int(n) for n in blob["allocator"]["in_stripe"]]
        eng.alloc.stripes_at_high_water = [
            int(n) for n in blob["allocator"]["stripes_at_high_water"]
        ]
        if eng.prefix is not None and "prefix" in blob:
            from repro_torch.serving.kv_cache import PrefixIndex

            eng.prefix = PrefixIndex.from_state(blob["prefix"])

"""SP strategy registry and the cost-model arbitration behind
``strategy="auto"`` (copy of ``repro.core.strategies``).

TokenRing moves ``O(Hq*D)`` bytes per direction per ring step while a
(bidirectional) KV ring moves ``O(Hkv*D)``, so the right schedule is a
function of shapes and links:

  * every strategy module registers an :class:`SPStrategy` descriptor: the
    per-rank callable, declarative capabilities and a ``comm_cost`` model
    with its closed-form per-device byte count;
  * ``ParallelContext.plan`` (``core/api.py``) resolves ``"auto"`` by
    evaluating every eligible registered model and taking the argmin of
    max-direction bytes, except that a ``kv_resident`` schedule wins
    whenever it is within :data:`KV_RESIDENT_MARGIN` of the cheapest.

The port registers the four ring strategies of ``core/token_ring.py`` and
``core/ring_attention.py`` and the two serving schedules of
``core/decode.py`` (planned through ``plan_decode`` / ``plan_prefill``, never
picked by ``"auto"``); asking for a strategy of the reference that is
not ported yet raises ``NotImplementedError`` naming its item (:data:`UNPORTED`).

Cost-model convention: ``comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2,
bidir_links=True, S_kv=None, **extra) -> CommCost`` with per-device bytes for
one full forward pass of one attention layer; ``S`` is the *global* query
sequence length, ``S_kv`` the KV sequence when it differs, ``extra`` the
strategy's knobs named in ``extra_kwargs`` (e.g. ``travel_dtype``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Mapping

__all__ = [
    "CommCost",
    "LinkCost",
    "SPStrategy",
    "UNPORTED",
    "register_strategy",
    "unregister_strategy",
    "get_strategy",
    "available_strategies",
    "ineligible_reason",
    "strategy_cost",
    "resolve_strategy",
    "attention_compute_flops",
    "itemsize",
    "ceil_div",
    "KV_RESIDENT_MARGIN",
    "LSE_BYTES",
]

# lse always travels as float32 — 4 bytes per (token, head) scalar.
LSE_BYTES = 4

# A KV-resident schedule is preferred while its max-direction byte count is
# within this factor of the cheapest eligible strategy (see module docstring).
# 1.3 covers TokenRing's lse + going-home overhead over the bidirectional KV
# ring at MHA for rings of P >= 3 (the overhead vanishes as P grows) while
# staying far below the >= 2x gap GQA opens in the other direction.
KV_RESIDENT_MARGIN = 1.3


@dataclass(frozen=True)
class LinkCost:
    """Per-device bytes of one pass attributed to one *link class* — the
    per-class refinement a hierarchical cost model declares so topology-aware
    pricing can rate each class at its own bandwidth (``cls`` matches
    ``core.topology.Link.cls``, e.g. ``"intra"`` / ``"inter"``)."""

    cls: str
    fwd_bytes: float
    bwd_bytes: float


@dataclass(frozen=True)
class CommCost:
    """Per-device link bytes of one forward pass, split by ring direction.

    ``links`` optionally refines the scalar totals by link class (see
    :class:`LinkCost`) for schedules whose hops cross heterogeneous wires —
    the hierarchical 2D schedule declares ``("intra", "inter")``.  Flat
    schedules leave it ``None`` and are priced as one implicit class.
    """

    fwd_bytes: float
    bwd_bytes: float
    links: tuple[LinkCost, ...] | None = None

    @property
    def max_direction(self) -> float:
        return max(self.fwd_bytes, self.bwd_bytes)

    @property
    def total(self) -> float:
        return self.fwd_bytes + self.bwd_bytes

    def link_costs(self) -> tuple[LinkCost, ...]:
        """The per-class breakdown, synthesizing one implicit class for flat
        cost models so every consumer can iterate uniformly."""
        if self.links is not None:
            return self.links
        return (LinkCost("link", self.fwd_bytes, self.bwd_bytes),)

    def time_s(
        self,
        link_bw,
        *,
        bidir_links: bool = True,
        half_duplex: frozenset = frozenset(),
    ) -> float:
        """Modeled link time: full-duplex fabrics overlap the directions.

        ``link_bw`` is a single bytes/s number (every class rated alike) or a
        mapping ``{cls: bytes/s}`` — then the time is the **max over the
        per-class ledger**, each class at its own bandwidth, with classes in
        ``half_duplex`` summing their directions instead of overlapping them
        (their two directions share one physical lane).
        """
        if isinstance(link_bw, Mapping):
            def lane(lc: LinkCost) -> float:
                both = (not bidir_links) or lc.cls in half_duplex
                b = lc.fwd_bytes + lc.bwd_bytes if both else max(
                    lc.fwd_bytes, lc.bwd_bytes
                )
                return b / link_bw[lc.cls] if b else 0.0

            return max(lane(lc) for lc in self.link_costs())
        bytes_ = self.max_direction if bidir_links else self.total
        return bytes_ / link_bw

    def step_time_s(
        self,
        link_bw,
        compute_s: float,
        *,
        bidir_links: bool = True,
        pipelined: bool = True,
        half_duplex: frozenset = frozenset(),
    ) -> float:
        """Modeled wall time of one whole pass of the schedule.

        The double-buffered executor (``core/schedule.py``) issues every
        transfer against data in hand at step entry, so a pipelined pass
        costs ``max(compute, link)`` — comm hides under compute (or vice
        versa).  ``pipelined=False`` models the legacy merge→rotate chain,
        where every transfer waits for the step's flash: ``compute + link``.
        ``link_bw`` generalizes to a per-class mapping exactly as in
        :meth:`time_s`.
        """
        link = self.time_s(
            link_bw, bidir_links=bidir_links, half_duplex=half_duplex
        )
        return max(compute_s, link) if pipelined else compute_s + link


@dataclass(frozen=True)
class SPStrategy:
    """Descriptor a strategy module registers for itself.

    ``fn`` runs on each rank's local shard (every rank's, folded into the
    batch dimension, on a virtual ring) with the uniform signature
    ``fn(q, k, v, q_pos, k_pos, *, ring, causal, window, scale, impl,
    block_q, block_k, block_q_bwd, block_k_bwd, overlap=True,
    return_lse=False, **extra)`` where ``ring`` is a transport of
    ``core.collectives`` and ``extra`` is limited to the names declared in
    ``extra_kwargs``; ``overlap=False`` runs the step schedule with each
    send after the step's computes (``core/schedule.py``).
    """

    name: str
    fn: Callable[..., Any]
    comm_cost: Callable[..., CommCost]
    supports_window: bool = False
    requires_window: bool = False  # meaningless without a window= argument
    supports_gqa: bool = True
    requires_layout: str | None = None  # e.g. "contig"; None = any layout
    hybrid_inner_ok: bool = True  # usable inside the Case-Study-III hybrid
    kv_resident: bool = False  # K/V never leave their home device
    head_divisible: bool = False  # needs Hq % P == 0 and Hkv % P == 0
    auto_eligible: bool = True  # considered by the "auto" planner
    # Runs a step schedule whose transfers overlap compute (the executor's
    # pipelined mode).  False for schedules with nothing to hide behind —
    # ulysses' blocking all-to-alls, window's fetch-then-compute halo — so
    # the planner's modeled_times never claims an overlap saving the
    # implementation cannot deliver.
    pipelines: bool = True
    # Serving-side schedules ("decode", "prefill") run replicated-Q against a
    # sequence-sharded resident cache: their fn signatures and partition specs
    # differ from the ring-attention family, so they are planned through
    # ``ParallelContext.plan_decode`` / ``plan_prefill`` — never through
    # ``sp_attention``.  Their comm_cost models still live here so the planner
    # prices serving schedules with the same machinery as training schedules.
    serving_side: bool = False
    # How many logical ring axes the schedule rotates on.  1 = the flat SP
    # ring every strategy above uses (fn takes one ``axis_name``).  2 = a
    # hierarchical (pod, inner) schedule: fn takes ``axis_name`` as a
    # ``(pod_axis, inner_axis)`` pair and is planned through
    # ``ParallelContext.plan(topology=...)``, never through the single-axis
    # auto pool (``ineligible_reason`` rejects it there).
    ring_axes: int = 1
    extra_kwargs: frozenset[str] = frozenset()
    # Optional rank-symbolic walk hook: ``schedule_spec(P, **dims) ->
    # core.schedule.ScheduleSpec`` returning the concrete step schedule plus
    # buffer metadata (roles, row fractions, wire dtypes).  Consumed by the
    # static analyzers in ``repro.analysis`` — the deadlock/coverage checker
    # and the byte-conservation audit that pins ``comm_cost`` to what the
    # schedule actually sends.  ``dims`` may include ``S_loc`` and ``window``
    # (halo schedules size themselves from both).  None = no step schedule to
    # analyze (all-to-all and serving-side strategies).
    schedule_spec: Callable[..., Any] | None = None
    description: str = ""


_CAPABILITY_FIELDS = frozenset(
    f.name for f in dataclasses.fields(SPStrategy) if f.name not in ("name", "fn", "comm_cost")
)

_REGISTRY: dict[str, SPStrategy] = {}
_BUILTINS_LOADED = False


def register_strategy(name: str, fn, *, comm_cost, **capabilities) -> SPStrategy:
    """Register an SP strategy; raises on duplicate names or unknown keys."""
    unknown = set(capabilities) - _CAPABILITY_FIELDS
    if unknown:
        raise ValueError(
            f"unknown capability key(s) {sorted(unknown)} for strategy "
            f"{name!r}; known: {sorted(_CAPABILITY_FIELDS)}"
        )
    if name in _REGISTRY:
        raise ValueError(f"SP strategy {name!r} is already registered")
    if not callable(fn) or not callable(comm_cost):
        raise ValueError(f"strategy {name!r}: fn and comm_cost must be callable")
    extra = capabilities.pop("extra_kwargs", frozenset())
    desc = SPStrategy(
        name=name, fn=fn, comm_cost=comm_cost,
        extra_kwargs=frozenset(extra), **capabilities,
    )
    _REGISTRY[name] = desc
    return desc


def unregister_strategy(name: str) -> None:
    """Remove a strategy (tests / plugin reload); missing names are a no-op."""
    _REGISTRY.pop(name, None)


# Strategies of the reference that the port has not copied yet, and where
# each comes (ROADMAP.md, queue 1).  Asking for one raises
# NotImplementedError naming its item, not the unknown-strategy ValueError.
UNPORTED = {
    "ulysses": "core/ulysses.py (ROADMAP queue 1 item 8)",
    "window": "core/window.py (ROADMAP queue 1 item 8)",
    "hybrid": "core/hybrid.py (ROADMAP queue 1 item 8)",
    "tokenring2d": "core/hier2d.py (ROADMAP queue 1 item 8)",
    "passkv_ring": "core/prefill_rings.py (ROADMAP queue 1 item 8)",
    "passq_ring": "core/prefill_rings.py (ROADMAP queue 1 item 8)",
}


def not_ported(name: str) -> str:
    return f"SP strategy {name!r} is not ported yet: it comes with {UNPORTED[name]}"


def _ensure_builtins() -> None:
    """Import the ported strategy modules so they self-register.

    Lazy so that registry order never depends on which ``repro_torch.core``
    submodule a consumer happened to import first.
    """
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    import repro_torch.core.decode  # noqa: F401
    import repro_torch.core.ring_attention  # noqa: F401
    import repro_torch.core.token_ring  # noqa: F401


def get_strategy(name: str) -> SPStrategy:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in UNPORTED:
            raise NotImplementedError(not_ported(name)) from None
        raise ValueError(
            f"unknown SP strategy {name!r}; registered: {available_strategies()}"
        ) from None


def available_strategies() -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def ineligible_reason(
    desc: SPStrategy,
    *,
    Hq: int,
    Hkv: int,
    P: int,
    layout: str | None = None,
    window: int | None = None,
) -> str | None:
    """Why ``desc`` cannot run this shape/config, or None if it can.

    Judged for the ring-attention (``sp_attention``) role: serving-side
    schedules are always ineligible here — they are planned via
    ``plan_decode`` / ``plan_prefill`` against a resident cache instead.
    """
    if desc.serving_side:
        return (
            "serving-side schedule (replicated Q vs resident sharded cache); "
            "plan via plan_decode/plan_prefill, not sp_attention"
        )
    if desc.ring_axes != 1:
        return (
            f"hierarchical schedule over {desc.ring_axes} ring axes; needs a "
            f"(pod, inner) mesh and is planned via "
            f"ParallelContext.plan(topology=...), not the flat-axis pool"
        )
    if window is not None and not desc.supports_window:
        return "does not implement sliding-window attention"
    if window is None and desc.requires_window:
        return "only implements sliding-window attention (needs window=)"
    if Hkv != Hq and not desc.supports_gqa:
        return f"no GQA support (Hq={Hq}, Hkv={Hkv})"
    if desc.head_divisible and (Hq % P or Hkv % P):
        return (
            f"needs head counts divisible by the SP degree "
            f"(Hq={Hq}, Hkv={Hkv}, P={P})"
        )
    if desc.requires_layout and layout and layout != desc.requires_layout:
        return f"requires layout={desc.requires_layout!r}, got {layout!r}"
    return None


def _decision_travel_dtype(bytes_per_elem: int) -> str:
    # Schedule arbitration evaluates traveling accumulators at compute
    # precision: the wire format (``travel_dtype``) is an orthogonal knob and
    # must not flip which *schedule* is communication-optimal.
    return {1: "float8_e4m3fn", 2: "bfloat16", 4: "float32"}.get(
        bytes_per_elem, "float32"
    )


def strategy_cost(
    desc: SPStrategy,
    B: int,
    S: int,
    Hq: int,
    Hkv: int,
    D: int,
    P: int,
    *,
    bytes_per_elem: int = 2,
    bidir_links: bool = True,
    S_kv: int | None = None,
    **extra,
) -> CommCost:
    """Evaluate a descriptor's cost model, passing only its declared extras."""
    kw = {k: v for k, v in extra.items() if k in desc.extra_kwargs}
    return desc.comm_cost(
        B, S, Hq, Hkv, D, P, bytes_per_elem=bytes_per_elem,
        bidir_links=bidir_links, S_kv=S_kv, **kw,
    )


def resolve_strategy(
    name: str,
    *,
    B: int = 1,
    S: int,
    Hq: int,
    Hkv: int,
    D: int,
    P: int,
    bytes_per_elem: int = 2,
    bidir_links: bool = True,
    S_kv: int | None = None,
    layout: str | None = None,
    window: int | None = None,
    candidates: tuple[str, ...] | None = None,
) -> str:
    """Resolve ``"auto"`` to the concrete registered strategy with the least
    modeled link time; explicit names are validated and returned unchanged.

    The argmin runs over eligible, ``auto_eligible`` strategies using each
    model's max-direction bytes (or total bytes on half-duplex fabrics), with
    the KV-residency margin described in the module docstring.
    """
    if name != "auto":
        get_strategy(name)  # raise early on unknown names
        return name

    _ensure_builtins()
    pool = candidates if candidates is not None else available_strategies()
    extra = {"travel_dtype": _decision_travel_dtype(bytes_per_elem)}
    if window is not None:
        extra["window"] = window

    scored: list[tuple[float, SPStrategy]] = []
    reasons: dict[str, str] = {}
    for n in pool:
        desc = get_strategy(n)
        if not desc.auto_eligible:
            reasons[n] = "not auto-eligible"
            continue
        why = ineligible_reason(
            desc, Hq=Hq, Hkv=Hkv, P=P, layout=layout, window=window
        )
        if why is not None:
            reasons[n] = why
            continue
        cost = strategy_cost(
            desc, B, S, Hq, Hkv, D, P,
            bytes_per_elem=bytes_per_elem, bidir_links=bidir_links,
            S_kv=S_kv, **extra,
        )
        score = cost.max_direction if bidir_links else cost.total
        scored.append((score, desc))
    if not scored:
        raise ValueError(
            f"no eligible SP strategy for Hq={Hq}, Hkv={Hkv}, P={P}, "
            f"window={window}, layout={layout}: {reasons}"
        )
    scored.sort(key=lambda t: (t[0], t[1].name))
    best_score = scored[0][0]
    for score, desc in scored:
        if desc.kv_resident and score <= KV_RESIDENT_MARGIN * best_score:
            return desc.name
    return scored[0][1].name


# ---------------------------------------------------------------------------
# shared closed-form helpers used by the built-in cost models


def attention_compute_flops(
    B: int,
    S: int,
    Hq: int,
    D: int,
    P: int,
    *,
    S_kv: int | None = None,
    causal: bool = True,
    window: int | None = None,
) -> float:
    """Per-device dot FLOPs of one SP attention forward pass.

    ``4·B·S_loc·ctx·Hq·D`` (QKᵀ + PV), halved under causal masking (the
    kernel's tile skip realizes the saving — docs/kernels.md).  Windowed
    layers attend ~``min(window, halo context)`` keys per query instead (the
    window clip subsumes the causal triangle — no double halving).  This is
    the ``compute_est`` half of the planner's ``max(compute_est, link_time)``
    step-time model (docs/overlap.md).
    """
    S_loc = S // max(P, 1)
    ctx = S_kv or S
    if window is not None:
        # mirror window_attention_sp's halo exactly (core/window.py)
        halo = min(max(P - 1, 0), ceil_div(window - 1, max(S_loc, 1)))
        ctx = min(window, ctx, S_loc * (1 + halo))
        return 4.0 * B * S_loc * ctx * Hq * D
    return 4.0 * B * S_loc * ctx * Hq * D * (0.5 if causal else 1.0)


def itemsize(dtype_like) -> int:
    """Bytes of one element of a ``torch.dtype`` or a dtype name
    (``"bfloat16"``, ``"float32"``, ...)."""
    import torch

    dtype = getattr(torch, dtype_like) if isinstance(dtype_like, str) else dtype_like
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"not a dtype: {dtype_like!r}")
    return dtype.itemsize


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)

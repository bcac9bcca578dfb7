"""Static link-traffic prover: replay a schedule's message walk onto a
physical :class:`~repro_torch.core.topology.Topology` and audit every wire
(counterpart of ``repro.analysis.topo_check``).

``schedule_check`` proves a schedule *correct* and ``comm_audit`` pins its
*logical* per-direction bytes to the registered cost model.  Neither knows
which wire a hop crosses.  This pass closes that gap exactly: every Send of
every step is expanded to its P point-to-point messages, each message walks
its logical ring hop by hop (``schedule.message_route``), each logical hop is
mapped through a rank→device placement onto a shortest physical route, and
every traversed *directed lane* accrues the payload's wire bytes.  The
result is a per-link, per-step, per-direction byte ledger with no
abstraction loss — rank-and-step exhaustive, integer exact.

Findings (IDs in ``analysis.report.RULES``):

  * ``TOPO-OVERSUBSCRIBED`` — in one step, one directed lane carries either
    two different logical streams (distinct ``(axis, direction)``) or more
    than a dedicated-lane share of one stream (``lane_bytes * P >
    stream_bytes``): the bottleneck lane exceeds what per-lane pricing
    models.
  * ``TOPO-HALF-DUPLEX`` — the check was asked to price the fabric as
    full-duplex (``assume_bidir=True``) but a half-duplex link carries
    traffic both ways: its real time is the sum of the directions.
  * ``TOPO-CROSS-POD`` — the cost model declares a per-class split
    (``CommCost.links``) but inter-pod lanes carry more bytes than the
    inter-class declaration: the schedule crosses the slow link more often
    than the pricing admits (every step instead of once per super-step).
  * ``TOPO-COST-DRIFT`` — the ledger's per-class per-lane bytes, or the
    pass time it implies, disagree with the registered ``CommCost``
    evaluated under the same topology (``CommCost.time_s({cls: bw})``).

Defaults derive every pricing assumption *from the graph* (per-class
bandwidths, per-link duplex), so a correctly-declared schedule is clean on
any topology — the findings fire when a schedule or cost model *claims*
something the wires deny, which is exactly what the mutation tests inject.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.analysis.comm_audit import AuditDims, buffer_wire_bytes
from repro_torch.analysis.report import Finding
from repro_torch.core.schedule import (
    ScheduleSpec,
    axis_extent,
    message_route,
    ring_shift_hops,
)
from repro_torch.core.strategies import SPStrategy, itemsize, strategy_cost
from repro_torch.core.topology import Topology

__all__ = [
    "LinkLedger",
    "build_ledger",
    "check_spec_topology",
    "check_strategy_topology",
    "default_placement",
]

_REL_TOL = 1e-9


@dataclass
class LinkLedger:
    """Exact per-step, per-directed-lane byte ledger of one schedule pass.

    ``steps[i]`` maps a directed physical lane ``(device_a, device_b)`` to
    the bytes it carries during step ``i``; ``streams[i]`` maps the same
    lanes to the set of logical streams ``(axis_tag, "fwd"/"bwd")`` that put
    them there.  All byte counts are integers — no averaging, no rates.
    """

    topo: Topology
    placement: tuple[int, ...]
    n_ranks: int
    steps: list[dict] = field(default_factory=list)
    streams: list[dict] = field(default_factory=list)

    def lane_total(self, lane) -> int:
        return sum(rec.get(lane, 0) for rec in self.steps)

    def lanes(self) -> set:
        out: set = set()
        for rec in self.steps:
            out.update(rec)
        return out

    def link_pair(self, link) -> tuple[int, int]:
        """Per-link directional loads ``(max_lane, min_lane)`` over the pass."""
        a, b = self.lane_total((link.a, link.b)), self.lane_total((link.b, link.a))
        return (max(a, b), min(a, b))

    def traversed_links(self):
        lanes = self.lanes()
        return tuple(
            link
            for link in self.topo.links
            if (link.a, link.b) in lanes or (link.b, link.a) in lanes
        )

    def link_time_s(self, link) -> float:
        """Pass time of one link from its own lane totals and duplex."""
        hi, lo = self.link_pair(link)
        bytes_ = hi + lo if link.duplex == "half" else hi
        return bytes_ / link.bw

    def pass_time_s(self) -> float:
        """Ledger-derived pass time: the slowest wire bounds the schedule."""
        links = self.traversed_links()
        if not links:
            return 0.0
        return max(self.link_time_s(link) for link in links)

    def lane_dir_totals(self) -> dict:
        """Per directed lane: pass-total bytes split by *logical* direction
        (the ``"fwd"``/``"bwd"`` of the streams that crossed it)."""
        out: dict = {}
        for lane_streams in self.streams:
            for lane, streams in lane_streams.items():
                acc = out.setdefault(lane, {"fwd": 0, "bwd": 0})
                for (_, d), b in streams.items():
                    acc[d] += b
        return out

    def class_dir_max(self) -> dict:
        """Per link class: ``(fwd, bwd)`` — the max over lanes of each
        logical direction's pass bytes.  This is the quantity a per-rank
        ``CommCost``/``LinkCost`` declaration models: each rank's stream of
        one direction owns one dedicated lane per class."""
        out: dict[str, list] = {}
        for lane, dirs in self.lane_dir_totals().items():
            link = self.topo.link_between(*lane)
            if link is None:
                continue
            acc = out.setdefault(link.cls, [0, 0])
            acc[0] = max(acc[0], dirs["fwd"])
            acc[1] = max(acc[1], dirs["bwd"])
        return {cls: (f, b) for cls, (f, b) in out.items()}

    def active_steps(self, cls: str) -> list[int]:
        idxs = []
        for i, rec in enumerate(self.steps):
            for (a, b), bytes_ in rec.items():
                link = self.topo.link_between(a, b)
                if link is not None and link.cls == cls and bytes_:
                    idxs.append(i)
                    break
        return idxs

    def to_json(self) -> dict:
        return {
            "topology": self.topo.name,
            "placement": list(self.placement),
            "links": [
                {
                    "a": link.a,
                    "b": link.b,
                    "cls": link.cls,
                    "bw": link.bw,
                    "duplex": link.duplex,
                    "fwd_bytes": self.link_pair(link)[0],
                    "bwd_bytes": self.link_pair(link)[1],
                    "time_s": self.link_time_s(link),
                }
                for link in self.traversed_links()
            ],
            "steps": [
                {f"{a}->{b}": n for (a, b), n in sorted(rec.items())}
                for rec in self.steps
            ],
            "pass_time_s": self.pass_time_s(),
        }


def default_placement(spec: ScheduleSpec) -> str:
    """Hierarchical specs ride the row-major ``"grid"`` placement; flat
    specs the Hamiltonian ``"ring"`` cycle."""
    if spec.axes is not None and any(n > 1 for tag, n in spec.axes[:-1]):
        return "grid"
    return "ring"


def build_ledger(
    spec: ScheduleSpec,
    dims: AuditDims,
    topo: Topology,
    *,
    placement: str | None = None,
    include_positions: bool = False,
) -> LinkLedger:
    """Replay the full rank-symbolic walk onto physical lanes.

    Every message (Send op x source rank) contributes its payload bytes to
    every directed lane on the physical route of every logical hop — the
    torus convention prices a distance-``d`` send as ``d`` logical hops, the
    neighbor convention as ``min(s, n-s)``, both exactly as ``comm_audit``
    prices them, so the ledger's lane sums and the logical audit agree by
    construction.
    """
    P = topo.n_devices
    place = topo.placement(
        placement if placement is not None else default_placement(spec)
    )
    ledger = LinkLedger(topo=topo, placement=place, n_ranks=P)
    for step in spec.schedule.all_steps():
        lane_bytes: dict = {}
        lane_streams: dict = {}
        for op in step.sends:
            n = axis_extent(spec.axes, op.axis, P)
            hops, forward = ring_shift_hops(op.shift, n, torus=spec.torus_hops)
            if hops == 0:
                continue
            payload = sum(
                buffer_wire_bytes(
                    spec.buffers[name], dims,
                    include_positions=include_positions,
                )
                for name in op.buffers
                if name in spec.buffers
            )
            if payload == 0:
                continue
            stream = (op.axis, "fwd" if forward else "bwd")
            for src in range(P):
                for u, v in message_route(
                    op, src, P, spec.axes, torus_hops=spec.torus_hops
                ):
                    du, dv = place[u], place[v]
                    for lane in topo.route(du, dv):
                        lane_bytes[lane] = lane_bytes.get(lane, 0) + payload
                        lane_streams.setdefault(lane, {}).setdefault(
                            stream, 0
                        )
                        lane_streams[lane][stream] += payload
        ledger.steps.append(lane_bytes)
        ledger.streams.append(lane_streams)
    return ledger


def _check_oversubscribed(ledger: LinkLedger, subject: str):
    """Dedicated-lane discipline, per step: no lane serves two streams, and
    no lane carries more than a 1/P share of any stream's hop-bytes."""
    findings: list[Finding] = []
    seen: set = set()
    P = ledger.n_ranks
    for idx, lane_streams in enumerate(ledger.streams):
        stream_totals: dict = {}
        for streams in lane_streams.values():
            for stream, b in streams.items():
                stream_totals[stream] = stream_totals.get(stream, 0) + b
        for lane, streams in lane_streams.items():
            if len(streams) > 1 and ("multi", lane) not in seen:
                seen.add(("multi", lane))
                names = sorted(f"{a or 'ring'}:{d}" for a, d in streams)
                findings.append(
                    Finding(
                        "TOPO-OVERSUBSCRIBED",
                        subject,
                        f"step {idx}: directed lane {lane[0]}->{lane[1]} "
                        f"carries {len(streams)} logical streams "
                        f"({', '.join(names)}) in one step — the cost model "
                        f"prices them as parallel dedicated lanes",
                    )
                )
            for stream, b in streams.items():
                if b * P > stream_totals[stream] and ("share", lane, stream) not in seen:
                    seen.add(("share", lane, stream))
                    a, d = stream
                    findings.append(
                        Finding(
                            "TOPO-OVERSUBSCRIBED",
                            subject,
                            f"step {idx}: lane {lane[0]}->{lane[1]} carries "
                            f"{b} bytes of stream {a or 'ring'}:{d}, more "
                            f"than its dedicated-lane share "
                            f"{stream_totals[stream]}/{P} — the placement "
                            f"funnels the ring through this wire",
                        )
                    )
    return findings


def check_spec_topology(
    spec: ScheduleSpec,
    dims: AuditDims,
    topo: Topology,
    *,
    cost=None,
    placement: str | None = None,
    assume_bidir: bool | None = None,
    subject: str = "schedule",
):
    """``(ledger, findings)`` for one spec over one topology.

    ``cost`` is the registered :class:`CommCost` to hold the ledger against
    (omit to run the structural checks only).  ``assume_bidir`` is the
    *claimed* duplex pricing: ``None`` (default) derives it per link from the
    graph — the honest setting the CI gate runs — while ``True`` / ``False``
    assert full-/half-duplex pricing everywhere and let the analyzer catch
    claims the wires deny (the mutation tests).
    """
    ledger = build_ledger(
        spec, dims, topo, placement=placement, include_positions=False
    )
    findings = _check_oversubscribed(ledger, subject)

    traversed = ledger.traversed_links()
    if assume_bidir is True:
        for link in traversed:
            hi, lo = ledger.link_pair(link)
            if link.duplex == "half" and hi and lo:
                findings.append(
                    Finding(
                        "TOPO-HALF-DUPLEX",
                        subject,
                        f"link {link.a}<->{link.b} ({link.cls}) is "
                        f"half-duplex but carries {hi} + {lo} bytes in "
                        f"opposite directions priced as overlapping — real "
                        f"link time is the sum, double the claim",
                    )
                )

    if cost is None:
        return ledger, findings

    # claimed duplex pricing for the cost side of the comparison
    if assume_bidir is None:
        bidir, half_cls = True, topo.half_duplex_classes()
    elif assume_bidir:
        bidir, half_cls = True, frozenset()
    else:
        bidir, half_cls = False, frozenset()

    class_dirs = ledger.class_dir_max()
    declared = {lc.cls: lc for lc in cost.link_costs()}
    flagged_cross: set = set()

    if cost.links is not None:
        # per-class byte discipline; inter-pod excess is the CROSS-POD story
        inter_classes = {
            link.cls
            for link in topo.links
            if topo.pod_of(link.a) != topo.pod_of(link.b)
        }
        for cls, (f, b) in sorted(class_dirs.items()):
            lc = declared.get(cls)
            want = (lc.fwd_bytes, lc.bwd_bytes) if lc is not None else (0.0, 0.0)
            if cls in inter_classes and (f > want[0] or b > want[1]):
                flagged_cross.add(cls)
                steps = ledger.active_steps(cls)
                findings.append(
                    Finding(
                        "TOPO-CROSS-POD",
                        subject,
                        f"inter-pod class {cls!r} lanes carry "
                        f"({f}, {b}) bytes per direction but the cost model "
                        f"declares ({want[0]:.0f}, {want[1]:.0f}) — crossed "
                        f"at steps {steps} instead of once per super-step",
                    )
                )
        # byte-exact drift per class (CROSS-POD already told its classes)
        for cls in sorted(set(class_dirs) | set(declared)):
            if cls in flagged_cross:
                continue
            f, b = class_dirs.get(cls, (0, 0))
            lc = declared.get(cls)
            want = (lc.fwd_bytes, lc.bwd_bytes) if lc is not None else (0.0, 0.0)
            if (f, b) != want:
                findings.append(
                    Finding(
                        "TOPO-COST-DRIFT",
                        subject,
                        f"class {cls!r}: bottleneck-lane bytes ({f}, {b}) "
                        f"per direction vs declared ({want[0]:.0f}, "
                        f"{want[1]:.0f}); active at steps "
                        f"{ledger.active_steps(cls)}",
                    )
                )
    else:
        f = max((d[0] for d in class_dirs.values()), default=0)
        b = max((d[1] for d in class_dirs.values()), default=0)
        if (f, b) != (cost.fwd_bytes, cost.bwd_bytes):
            per_step = {
                i: dict(sorted(rec.items()))
                for i, rec in enumerate(ledger.steps)
                if rec
            }
            findings.append(
                Finding(
                    "TOPO-COST-DRIFT",
                    subject,
                    f"bottleneck-lane bytes ({f}, {b}) per direction vs "
                    f"comm_cost ({cost.fwd_bytes:.0f}, {cost.bwd_bytes:.0f});"
                    f" per-step lane bytes: {per_step}",
                )
            )

    # time-level drift: ledger pass time vs CommCost under the same graph
    if cost.links is not None:
        bws = topo.class_bandwidths()
        bw_arg = {
            lc.cls: bws.get(lc.cls, topo.bottleneck_bw())
            for lc in cost.link_costs()
        }
    else:
        bw_arg = {
            "link": min(
                (link.bw for link in traversed),
                default=topo.bottleneck_bw(),
            )
        }
        if assume_bidir is None:
            half_cls = frozenset(
                "link" for link in traversed if link.duplex == "half"
            )
    got = ledger.pass_time_s()
    model = cost.time_s(bw_arg, bidir_links=bidir, half_duplex=half_cls)
    ref = max(abs(got), abs(model), 1e-30)
    if abs(got - model) / ref > _REL_TOL:
        findings.append(
            Finding(
                "TOPO-COST-DRIFT",
                subject,
                f"ledger pass time {got:.6e}s vs CommCost.time_s "
                f"{model:.6e}s under {topo.name} — the planner would "
                f"arbitrate on a link time the wires deny",
            )
        )
    return ledger, findings


def check_strategy_topology(
    desc: SPStrategy,
    topo: Topology,
    *,
    B: int,
    S_loc: int,
    Hq: int,
    Hkv: int,
    D: int,
    bytes_per_elem: int = 2,
    travel_dtype: str = "float32",
    window: int | None = None,
    placement: str | None = None,
    assume_bidir: bool | None = None,
):
    """Topology findings for one registered strategy (None = no schedule).

    ``P`` is the device count of the topology; hierarchical strategies
    (``ring_axes == 2``) are instantiated with the topology's own pod count,
    so the same registry row is checked as a flat bidirectional ring on a
    single-pod graph and as the true 2D schedule on a podded one.
    """
    if desc.schedule_spec is None:
        return None
    P = topo.n_devices
    extra: dict = {}
    if desc.ring_axes == 2:
        extra["n_pods"] = topo.n_pods
        if P % topo.n_pods:
            return None
    spec = desc.schedule_spec(P, S_loc=S_loc, window=window, **extra)
    dims = AuditDims(
        B=B, S_loc=S_loc, Hq=Hq, Hkv=Hkv, D=D,
        bytes_per_elem=bytes_per_elem,
        travel_bytes=itemsize(travel_dtype),
    )
    cost = strategy_cost(
        desc, B, S_loc * P, Hq, Hkv, D, P,
        bytes_per_elem=bytes_per_elem, travel_dtype=travel_dtype,
        window=window, **extra,
    )
    subject = (
        f"{desc.name}[{topo.name},B={B},S_loc={S_loc},Hq={Hq},Hkv={Hkv},"
        f"D={D},bpe={bytes_per_elem}]"
    )
    _, findings = check_spec_topology(
        spec, dims, topo, cost=cost, placement=placement,
        assume_bidir=assume_bidir, subject=subject,
    )
    return findings

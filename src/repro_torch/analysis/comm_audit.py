"""Byte-conservation audit: schedule walk bytes == ``comm_cost`` closed form
(counterpart of ``repro.analysis.comm_audit``).

The auto-planner arbitrates strategies on their registered ``comm_cost``
models; nothing so far forced those closed forms to equal what the schedules
actually put on the wire.  This pass walks a ``ScheduleSpec`` step by step
with exact integer dims, prices every Send per direction, and demands *exact*
equality with the model — any drift (a dropped send, a changed trip count, a
buffer resized without touching the model) is a COMM-DRIFT finding.

Direction/hop convention (``schedule.ring_shift_hops``, as the ring
transports of ``core.collectives`` count their sends): a shift ``s`` (mod P)
travels ``min(s, P-s)`` neighbor hops, forward iff ``s < P - s``; when both
ways are equidistant (P=2, or ``s = P/2``) the schedule's declared sign
decides — so the audited numbers are directly comparable with a ring's
per-direction byte ledger.  ``torus_hops`` specs (TokenRing Algorithm 1) are
priced as written instead: a distance-``d`` send costs ``d`` hop-bytes in
the direction of its sign, the paper's torus model.

``include_positions=True`` adds the int32 position rows that travel with
q/kv payloads — excluded from the ``comm_cost`` comparison (the models price
attention payloads only; the ring's ledger counts positions apart).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.report import Finding
from repro_torch.core.schedule import ScheduleSpec, axis_extent, ring_shift_hops
from repro_torch.core.strategies import SPStrategy, itemsize, strategy_cost

__all__ = [
    "AuditDims",
    "buffer_wire_bytes",
    "hop_ledger",
    "audit_schedule",
    "audit_strategy",
]

POS_BYTES = 4  # positions are int32
LSE_BYTES = 4  # lse is float32


@dataclass(frozen=True)
class AuditDims:
    """Concrete per-device dims the symbolic walk is evaluated at."""

    B: int
    S_loc: int
    Hq: int
    Hkv: int
    D: int
    bytes_per_elem: int = 4
    travel_bytes: int = 4


def buffer_wire_bytes(
    bspec, dims: AuditDims, *, include_positions: bool
) -> int:
    """Exact wire bytes of one buffer's payload per hop."""
    rows = bspec.frac * dims.S_loc
    if rows != int(rows):
        raise ValueError(
            f"frac={bspec.frac} of S_loc={dims.S_loc} is not a whole row count"
        )
    rows = int(rows)
    heads = dims.Hq if bspec.heads == "q" else dims.Hkv
    elem = {
        "input": dims.bytes_per_elem,
        "travel": dims.travel_bytes,
        "f32": 4,
    }[bspec.elem]
    n_tensors = 2 if bspec.role == "kv" else 1
    total = n_tensors * dims.B * rows * heads * dims.D * elem
    if bspec.lse:
        total += dims.B * rows * heads * LSE_BYTES
    if bspec.positions and include_positions:
        total += dims.B * rows * POS_BYTES
    return total


def hop_ledger(
    spec: ScheduleSpec,
    P: int,
    dims: AuditDims,
    *,
    include_positions: bool = False,
    subject: str = "schedule",
):
    """Per-step per-direction byte ledger: ``(steps, findings)``.

    ``steps`` is one record per schedule step: ``{"step": idx, "fwd": bytes,
    "bwd": bytes, "sends": [...]}`` where each send entry carries the op's
    buffers, axis tag, shift, hop count, direction, and priced bytes.  This
    is what lets drift findings cite the *exact step* where a schedule and
    its cost model diverge, and what ``analysis.topo_check`` replays onto
    physical links.  Direction/hop convention: ``schedule.ring_shift_hops``
    on each Send's own ring (the flat P-ring, or its ``axes`` extent).
    """
    findings: list[Finding] = []
    unspeced: set[str] = set()
    steps: list[dict] = []
    for idx, step in enumerate(spec.schedule.all_steps()):
        rec = {"step": idx, "fwd": 0, "bwd": 0, "sends": []}
        for op in step.sends:
            n = axis_extent(spec.axes, op.axis, P)
            hops, forward = ring_shift_hops(
                op.shift, n, torus=spec.torus_hops
            )
            if hops == 0:
                continue  # SCHED-DEADLOCK territory; nothing moves
            op_bytes = 0
            for name in op.buffers:
                bspec = spec.buffers.get(name)
                if bspec is None:
                    if name not in unspeced:
                        unspeced.add(name)
                        findings.append(
                            Finding(
                                "COMM-UNSPECED",
                                subject,
                                f"step {idx}: Send moves {name!r} which has "
                                f"no BufferSpec — cannot price the transfer",
                            )
                        )
                    continue
                op_bytes += buffer_wire_bytes(
                    bspec, dims, include_positions=include_positions
                )
            b = hops * op_bytes
            rec["fwd" if forward else "bwd"] += b
            rec["sends"].append(
                {
                    "buffers": list(op.buffers),
                    "axis": op.axis,
                    "shift": op.shift,
                    "hops": hops,
                    "dir": "fwd" if forward else "bwd",
                    "bytes": b,
                }
            )
        steps.append(rec)
    return steps, findings


def audit_schedule(
    spec: ScheduleSpec,
    P: int,
    dims: AuditDims,
    *,
    include_positions: bool = False,
    subject: str = "schedule",
):
    """``(fwd_bytes, bwd_bytes, findings)`` for one full schedule pass.

    Per-device bytes: SPMD symmetry means every rank sends the same payloads,
    so one rank's walk is the per-device count the cost models quote.  The
    per-step breakdown behind these totals is :func:`hop_ledger`.
    """
    steps, findings = hop_ledger(
        spec, P, dims, include_positions=include_positions, subject=subject
    )
    fwd = sum(rec["fwd"] for rec in steps)
    bwd = sum(rec["bwd"] for rec in steps)
    return fwd, bwd, findings


def audit_strategy(
    desc: SPStrategy,
    *,
    B: int,
    S: int,
    Hq: int,
    Hkv: int,
    D: int,
    P: int,
    bytes_per_elem: int = 4,
    travel_dtype: str = "float32",
    window: int | None = None,
):
    """COMM-DRIFT findings comparing the schedule walk against ``comm_cost``.

    Returns ``None`` when the strategy declares no ``schedule_spec`` (nothing
    to audit), else the findings list (empty = exact agreement).
    """
    if desc.schedule_spec is None:
        return None
    S_loc = S // P
    spec = desc.schedule_spec(P, S_loc=S_loc, window=window)
    dims = AuditDims(
        B=B, S_loc=S_loc, Hq=Hq, Hkv=Hkv, D=D,
        bytes_per_elem=bytes_per_elem,
        travel_bytes=itemsize(travel_dtype),
    )
    subject = (
        f"{desc.name}[P={P},B={B},S={S},Hq={Hq},Hkv={Hkv},D={D},"
        f"bpe={bytes_per_elem}]"
    )
    steps, findings = hop_ledger(
        spec, P, dims, include_positions=False, subject=subject
    )
    cost = strategy_cost(
        desc, B, S, Hq, Hkv, D, P,
        bytes_per_elem=bytes_per_elem, travel_dtype=travel_dtype,
        window=window,
    )
    for direction, model in (("fwd", cost.fwd_bytes), ("bwd", cost.bwd_bytes)):
        got = sum(rec[direction] for rec in steps)
        if got != model:
            per_step = {
                rec["step"]: rec[direction] for rec in steps if rec[direction]
            }
            findings.append(
                Finding(
                    "COMM-DRIFT",
                    subject,
                    f"{direction}: schedule sends {got} bytes but comm_cost "
                    f"models {model:.0f} (drift {got - model:+.0f}); "
                    f"per-step {direction} bytes: {per_step}",
                )
            )
    return findings

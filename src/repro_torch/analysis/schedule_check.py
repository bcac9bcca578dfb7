"""Rank-symbolic execution of a ``core.schedule.Schedule`` across all P ranks
(counterpart of ``repro.analysis.schedule_check``, over the port's schedule IR).

The executor runs one rank's view of a schedule; this checker runs *all* of
them, with abstract values instead of arrays:

  * a query buffer holds ``QVal(home, part, rows)`` — whose query block it is;
  * a KV buffer holds ``KVVal({(home, part), ...}, rows)`` — which KV blocks;
  * an accumulator holds ``Partial(q, kv_multiset, rows)`` — which query the
    partial belongs to and exactly which KV blocks it has attended so far.

One SPMD ``Send`` is P point-to-point messages (``schedule.step_messages``);
walking them moves the abstract values around the ring exactly as the ring's
shift moves the tensors.  The checks:

  * **deadlock freedom** (SCHED-DEADLOCK) — no Send's shift is 0 mod P;
  * **matched sends** (SCHED-UNMATCHED) — every receive slot is written by
    exactly one message per step;
  * **snapshot→commit discipline** (SCHED-VALIDATE) — delegated to
    ``Schedule.validate`` (generation aliasing, unknown reads, body carry);
  * **merge discipline** (SCHED-MERGE-MISMATCH / SCHED-DUP-COVER /
    SCHED-SHAPE) — every Merge folds a partial of the *same query* and the
    same row count, never the same KV block twice;
  * **carry conservation** (SCHED-SHAPE) — a scan-body trip leaves every
    carried buffer's row count unchanged;
  * **coverage** (SCHED-COVERAGE) — each rank's outputs end home having
    attended exactly the promised ``(kv_home, kv_part)`` set.

Because the walk is exhaustive over ranks and steps and the value domain is
exact (no abstraction losing information), a clean report is a proof for the
given P — not a heuristic.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.report import Finding
from repro_torch.core.schedule import (
    Compute,
    Merge,
    Schedule,
    ScheduleError,
    ScheduleSpec,
    Send,
    axis_extent,
    message_dst,
)

__all__ = ["QVal", "KVVal", "Partial", "check_schedule_spec"]


@dataclass(frozen=True)
class QVal:
    home: int
    part: int
    rows: float


@dataclass(frozen=True)
class KVVal:
    parts: frozenset  # {(home, part), ...}
    rows: float


@dataclass(frozen=True)
class Partial:
    q: QVal | None
    kv: tuple  # sorted multiset of (home, part)
    rows: float


def _initial_state(spec: ScheduleSpec, P: int) -> list[dict]:
    state: list[dict] = []
    for r in range(P):
        vals: dict = {}
        for name, b in spec.buffers.items():
            if b.virtual:
                continue  # created by the schedule, no initial value
            if b.role == "q":
                vals[name] = QVal(r, b.part, b.frac)
            elif b.role == "kv":
                vals[name] = KVVal(frozenset({(r, b.part)}), b.frac)
            elif b.role == "acc":
                q = None
                if b.bound_q is not None:
                    qspec = spec.buffers[b.bound_q]
                    q = QVal(r, qspec.part, qspec.frac)
                vals[name] = Partial(q, (), b.frac)
            else:
                raise ValueError(f"unknown buffer role {b.role!r} for {name!r}")
        state.append(vals)
    return state


def _structure_findings(schedule: Schedule, subject: str, P: int, axes=None):
    """Deadlock + unmatched-send checks (pure step structure, no walk).

    Each Send is judged on its *own* ring: the flat P-ring, or — for
    hierarchical schedules whose Sends carry an ``axis`` tag — the extent of
    that axis under the spec's row-major factorization.
    """
    findings: list[Finding] = []
    seen: set = set()
    for idx, step in enumerate(schedule.all_steps()):
        send_targets: list[str] = []
        for op in step.sends:
            n = axis_extent(axes, op.axis, P)
            if n > 1 and op.shift % n == 0:
                key = ("deadlock", op.buffers, op.shift, op.axis)
                if key not in seen:
                    seen.add(key)
                    ring = f"P={P}" if op.axis is None else f"axis {op.axis!r}={n}"
                    findings.append(
                        Finding(
                            "SCHED-DEADLOCK",
                            subject,
                            f"step {idx}: Send{op.buffers} has shift "
                            f"{op.shift} ≡ 0 (mod {ring}) — the payload never "
                            f"leaves its rank and every receive goes unposted",
                        )
                    )
            send_targets += list(op.targets)
        dups = sorted({t for t in send_targets if send_targets.count(t) > 1})
        for t in dups:
            key = ("unmatched", idx, t)
            if key not in seen:
                seen.add(key)
                findings.append(
                    Finding(
                        "SCHED-UNMATCHED",
                        subject,
                        f"step {idx}: receive slot {t!r} is written by "
                        f"{send_targets.count(t)} messages in one step — "
                        f"sends and receives do not pair up one-to-one",
                    )
                )
    return findings


def check_schedule_spec(spec: ScheduleSpec, P: int, *, subject: str = "schedule"):
    """All schedule-level findings for ``spec`` on a ring of ``P`` ranks."""
    schedule = spec.schedule
    findings = _structure_findings(schedule, subject, P, spec.axes)

    initial = {n for n, b in spec.buffers.items() if not b.virtual}
    try:
        schedule.validate(initial)
    except ScheduleError as e:
        if not findings:
            findings.append(Finding("SCHED-VALIDATE", subject, str(e)))
    if findings:
        return findings  # state after a structural defect is meaningless

    def bad(rule: str, detail: str) -> None:
        findings.append(Finding(rule, subject, detail))

    state = _initial_state(spec, P)
    steps = schedule.all_steps()
    n_pro = len(schedule.prologue)
    trips = schedule.trips if schedule.body is not None else 0
    carry_sig: dict | None = None  # rows signature at body entry

    for idx, step in enumerate(steps):
        writes: list[dict] = [dict() for _ in range(P)]
        for op in step.ops:
            if isinstance(op, Send):
                for src in range(P):
                    dst = message_dst(src, op, P, spec.axes)
                    for b, tgt in zip(op.buffers, op.targets):
                        writes[dst][tgt] = state[src][b]
            elif isinstance(op, Compute):
                for r in range(P):
                    q = state[r][op.q]
                    if not isinstance(q, QVal):
                        if r == 0:
                            bad(
                                "SCHED-VALIDATE",
                                f"step {idx}: Compute reads {op.q!r} which "
                                f"holds {type(q).__name__}, not a query",
                            )
                        continue
                    blocks: list = []
                    for name in op.kv:
                        kv = state[r][name]
                        if not isinstance(kv, KVVal):
                            if r == 0:
                                bad(
                                    "SCHED-VALIDATE",
                                    f"step {idx}: Compute reads {name!r} "
                                    f"which holds {type(kv).__name__}, not KV",
                                )
                            blocks = None
                            break
                        blocks += sorted(kv.parts)
                    if blocks is None:
                        continue
                    dup = sorted({b for b in blocks if blocks.count(b) > 1})
                    if dup and r == 0:
                        bad(
                            "SCHED-DUP-COVER",
                            f"step {idx}: Compute {op.out!r} attends KV "
                            f"block(s) {dup} more than once in one flash",
                        )
                    writes[r][op.out] = Partial(q, tuple(sorted(blocks)), q.rows)
        for r in range(P):
            state[r].update(writes[r])  # commit — generation g+1
        for op in step.ops:
            if not isinstance(op, Merge):
                continue
            for r in range(P):
                dest, src = state[r][op.dest], state[r][op.src]
                if not (isinstance(dest, Partial) and isinstance(src, Partial)):
                    if r == 0:
                        bad(
                            "SCHED-VALIDATE",
                            f"step {idx}: Merge({op.dest!r}, {op.src!r}) on "
                            f"non-partial value(s)",
                        )
                    continue
                if dest.rows != src.rows:
                    if r == 0:
                        bad(
                            "SCHED-SHAPE",
                            f"step {idx}: Merge({op.dest!r}, {op.src!r}) folds "
                            f"{src.rows} rows into a {dest.rows}-row "
                            f"accumulator — shapes not conserved",
                        )
                    continue
                if dest.q is not None and src.q is not None and dest.q != src.q:
                    if r == 0:
                        bad(
                            "SCHED-MERGE-MISMATCH",
                            f"step {idx}: Merge({op.dest!r}, {op.src!r}) folds "
                            f"a partial of query (home={src.q.home}, "
                            f"part={src.q.part}) into the accumulator of "
                            f"query (home={dest.q.home}, part={dest.q.part})",
                        )
                    continue
                merged = list(dest.kv) + list(src.kv)
                dup = sorted({b for b in merged if merged.count(b) > 1})
                if dup and r == 0:
                    bad(
                        "SCHED-DUP-COVER",
                        f"step {idx}: Merge({op.dest!r}, {op.src!r}) "
                        f"accumulates KV block(s) {dup} twice",
                    )
                state[r][op.dest] = Partial(
                    dest.q or src.q, tuple(sorted(merged)), dest.rows
                )
        # carry conservation across scan trips (body steps only)
        if n_pro <= idx < n_pro + trips:
            sig = {
                n: getattr(state[0][n], "rows", None)
                for n in spec.buffers
                if n not in schedule.static and n in state[0]
            }
            if carry_sig is None:
                carry_sig = sig
            elif sig != carry_sig:
                changed = sorted(n for n in sig if sig[n] != carry_sig[n])
                bad(
                    "SCHED-SHAPE",
                    f"step {idx}: scan-body trip changed carried buffer "
                    f"row counts for {changed} — the loop's carry would "
                    f"change shape trip-to-trip",
                )
                carry_sig = sig

    # final coverage: every output is home with exactly the promised blocks
    for r in range(P):
        expected = spec.expected_coverage(P, r)
        for name in spec.out:
            val = state[r].get(name)
            if not isinstance(val, Partial):
                if r == 0:
                    bad(
                        "SCHED-VALIDATE",
                        f"output {name!r} holds {type(val).__name__}, not an "
                        f"accumulated partial",
                    )
                continue
            if val.q is not None and val.q.home != r:
                bad(
                    "SCHED-MERGE-MISMATCH",
                    f"output {name!r} on rank {r} holds the partial of rank "
                    f"{val.q.home}'s query — the accumulator did not come home",
                )
                continue
            got = set(val.kv)
            missing = sorted(expected - got)
            extra = sorted(got - expected)
            if missing:
                bad(
                    "SCHED-COVERAGE",
                    f"output {name!r} on rank {r} never attended KV "
                    f"block(s) {missing}",
                )
            if extra:
                bad(
                    "SCHED-COVERAGE",
                    f"output {name!r} on rank {r} attended unexpected KV "
                    f"block(s) {extra}",
                )
    return findings

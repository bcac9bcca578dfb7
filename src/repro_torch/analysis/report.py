"""Finding records, the rule catalog, and the findings-per-rule report
(counterpart of ``repro.analysis.report``).

Every pass in ``repro_torch.analysis`` emits :class:`Finding` objects tagged
with a rule ID from :data:`RULES`.  The IDs are the reference's, word for
word, except for the kernel rules: the reference prices Pallas BlockSpecs
against a TPU core's VMEM (``KERN-VMEM``) and checks a jaxpr for overlap
(``OVLP-BLOCKED``); the port lints its Hopper instances instead
(``KERN-SMEM``, ``KERN-SPILL``, ``KERN-WGMMA-SERIAL``, ``KERN-CLUSTER``) and
has no jaxpr.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

__all__ = ["Finding", "Report", "RULES"]

# Rule catalog: ID -> one-line description.  Grouped by analyzer pass.
RULES: dict[str, str] = {
    # schedule_check — rank-symbolic walk of a core.schedule.Schedule
    "SCHED-DEADLOCK": (
        "a Send's shift is 0 mod P: every rank posts a receive no other rank "
        "ever sends — the ring waits forever"
    ),
    "SCHED-UNMATCHED": (
        "a receive slot is written by more than one message in one step "
        "(two Sends land in the same buffer) — unmatched/colliding sends"
    ),
    "SCHED-VALIDATE": (
        "the schedule fails core.schedule.Schedule.validate (aliasing "
        "writes, unknown reads, bad body/static discipline)"
    ),
    "SCHED-MERGE-MISMATCH": (
        "a Merge folds a partial belonging to a different query than the "
        "accumulator's (e.g. a flipped shift direction desynchronized the "
        "accumulator from its co-rotating query), or the final accumulator "
        "ends on the wrong rank"
    ),
    "SCHED-DUP-COVER": (
        "an output accumulates the same (kv_home, kv_part) block twice — "
        "double-merged partials silently skew the softmax denominator"
    ),
    "SCHED-COVERAGE": (
        "an output never accumulates some (kv_home, kv_part) block the "
        "strategy promises to attend to — dropped send or short trip count"
    ),
    "SCHED-SHAPE": (
        "carry shapes are not conserved: a Merge folds mismatched row "
        "fractions, or a scan-body trip changes a carried buffer's shape"
    ),
    # comm_audit — byte conservation against the comm_cost closed form
    "COMM-DRIFT": (
        "the per-direction bytes the schedule actually sends differ from the "
        "registered comm_cost closed form — the auto-planner would arbitrate "
        "on numbers the wire does not match"
    ),
    "COMM-UNSPECED": (
        "a schedule sends a buffer with no BufferSpec — the audit cannot "
        "price it"
    ),
    # kernel_lint — the Hopper instances' shared memory, registers,
    # clusters, grids and skip predicates
    "KERN-SMEM": (
        "a kernel instance's dynamic shared memory at a call's length exceeds "
        "the block's opt-in maximum (the library refuses the launch with "
        "cudaErrorInvalidValue), or the card allows less than the library "
        "opts in to"
    ),
    "KERN-SPILL": (
        "ptxas spills registers to local memory in a gated instance (a wgmma "
        "instance of A, B1 or B2, or the decode core's cluster instance)"
    ),
    "KERN-WGMMA-SERIAL": (
        "ptxas serialises a wgmma instance's wgmma.mma_async (C7512): too few "
        "registers for the wgmma pipeline"
    ),
    "KERN-CLUSTER": (
        "a call on the decode core's cluster instance launches more clusters "
        "than the card holds at once — a second wave the one-wave rule does "
        "not price"
    ),
    "KERN-GRID-COVER": (
        "the kernel grid does not tile the sequence exactly: grid_size * "
        "block != S (rows computed twice or never)"
    ),
    "KERN-LIVE-SKIP": (
        "the tile-skip predicate skips a tile that contains at least one "
        "visible (query, key) pair — silently dropped attention mass"
    ),
    "KERN-PAGED-BOUNDS": (
        "the paged-decode kernel's block-table address rule reads a pool "
        "page outside [0, n_pages) — an out-of-bounds page read"
    ),
    "KERN-PAGED-SENTINEL": (
        "the paged-decode skip predicate mishandles the unmapped sentinel: "
        "it attends an aliased page, or skips a mapped page with visible "
        "keys"
    ),
    # preconditions — shared divisibility/message catalog
    "PRE-EVEN-SPLIT": (
        "a bidirectional split needs an even local sequence length "
        "(token_ring bidir splits Q, ring_bidir splits KV)"
    ),
    "PRE-ZIGZAG-DIV": (
        "zigzag layout needs the global sequence length divisible by 2P"
    ),
    "PRE-TILE-DIV": (
        "the sequence length admits no power-of-two tile >= the sublane "
        "minimum (_pick_block would degrade to near-per-row grid steps)"
    ),
    # topo_check — per-link ledger of a schedule replayed onto a Topology
    "TOPO-OVERSUBSCRIBED": (
        "two logical streams (or an uneven share of one stream) land on one "
        "directed physical lane in one step — the cost model prices lanes "
        "as dedicated, so the bottleneck lane exceeds the modeled link time"
    ),
    "TOPO-HALF-DUPLEX": (
        "a bidirectional schedule is priced full-duplex over a half-duplex "
        "link: both directions share one lane and the real link time is the "
        "sum, not the max, of the per-direction times"
    ),
    "TOPO-CROSS-POD": (
        "inter-pod links carry more bytes than the cost model's inter-class "
        "declaration — the schedule crosses the slow link every step where "
        "the pricing assumes once per super-step"
    ),
    "TOPO-COST-DRIFT": (
        "the per-link ledger's pass time (or per-class per-lane bytes) "
        "disagrees with the registered CommCost evaluated under the same "
        "topology — the planner would arbitrate on numbers the wires deny"
    ),
}


@dataclass(frozen=True)
class Finding:
    """One rule violation at one site."""

    rule: str
    subject: str  # strategy / kernel-instance / shape-point identifier
    detail: str

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown rule ID {self.rule!r}")

    def __str__(self) -> str:
        return f"[{self.rule}] {self.subject}: {self.detail}"


@dataclass
class Report:
    """Accumulated findings with per-rule grouping and text rendering."""

    findings: list[Finding] = field(default_factory=list)
    checked: Counter = field(default_factory=Counter)  # pass name -> sites

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def note_checked(self, pass_name: str, n: int = 1) -> None:
        self.checked[pass_name] += n

    @property
    def ok(self) -> bool:
        return not self.findings

    def by_rule(self) -> dict[str, list[Finding]]:
        out: dict[str, list[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def render(self, *, verbose: bool = False) -> str:
        lines = []
        for pass_name in sorted(self.checked):
            lines.append(
                f"  checked {pass_name}: {self.checked[pass_name]} sites"
            )
        grouped = self.by_rule()
        for rule in sorted(RULES):
            hits = grouped.get(rule, [])
            if hits:
                lines.append(f"  rule {rule}: {len(hits)} finding(s)")
                for f in hits:
                    lines.append(f"    - {f.subject}: {f.detail}")
            elif verbose:
                lines.append(f"  rule {rule}: clean")
        verdict = (
            "OK: 0 findings"
            if self.ok
            else f"FAIL: {len(self.findings)} finding(s)"
        )
        return "\n".join([*lines, verdict])

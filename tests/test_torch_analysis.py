"""The port's static analysis passes (``repro_torch.analysis``: schedule
check, comm audit, topology check, report, preconditions, and the
``launch/analyze.py`` gate) against the JAX package's on the same inputs.

Every registered strategy comes back clean in both packages, and every
corrupted schedule of ``tests/test_analysis.py`` gives the same ``(rule,
subject)`` findings in the port as in the reference.  The comm audit is also
held to the bytes the port's virtual ring is really handed.
"""

import math
import types
from dataclasses import replace

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.analysis.comm_audit as j_audit
import repro.analysis.schedule_check as j_sched_check
import repro.analysis.topo_check as j_topo
import repro.core.hier2d as j_hier2d
import repro.core.prefill_rings as j_prefill
import repro.core.ring_attention as j_ring
import repro.core.schedule as j_schedule
import repro.core.strategies as j_strat
import repro.core.token_ring as j_tr
import repro.core.topology as j_topology
import repro.core.window as j_window
import repro_torch.analysis.comm_audit as t_audit
import repro_torch.analysis.schedule_check as t_sched_check
import repro_torch.analysis.topo_check as t_topo
import repro_torch.core.hier2d as t_hier2d
import repro_torch.core.prefill_rings as t_prefill
import repro_torch.core.ring_attention as t_ring
import repro_torch.core.schedule as t_schedule
import repro_torch.core.strategies as t_strat
import repro_torch.core.token_ring as t_tr
import repro_torch.core.topology as t_topology
import repro_torch.core.window as t_window
from repro_torch.analysis import preconditions as tpre
from repro_torch.analysis.report import RULES, Finding, Report
from repro_torch.core import api as tapi
from repro_torch.core.collectives import VirtualRing

P = 4


def package(port: bool):
    """One package's schedule IR, spec factories, topologies and passes."""
    if port:
        mods = (t_schedule, t_ring, t_tr, t_prefill, t_hier2d, t_window, t_topology, t_strat,
                t_sched_check, t_audit, t_topo)
    else:
        mods = (j_schedule, j_ring, j_tr, j_prefill, j_hier2d, j_window, j_topology, j_strat,
                j_sched_check, j_audit, j_topo)
    ns = types.SimpleNamespace()
    for m in mods:
        ns.__dict__.update({k: v for k, v in vars(m).items() if not k.startswith("_")})
    ns.DIMS = ns.AuditDims(B=2, S_loc=64, Hq=8, Hkv=2, D=64)
    return ns


PKGS = {"jax": package(False), "port": package(True)}


def pairs(findings):
    return sorted((f.rule, f.subject) for f in findings or [])


def both(fn):
    """``fn(package)`` in the reference and in the port."""
    return fn(PKGS["jax"]), fn(PKGS["port"])


# ---------------------------------------------------------------------------
# clean baselines: every registered strategy, several ring sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(t_strat.available_strategies()))
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_registered_strategies_clean_as_in_jax(name, p):
    assert sorted(t_strat.available_strategies()) == sorted(j_strat.available_strategies())

    def run(k):
        desc = k.get_strategy(name)
        if desc.schedule_spec is None:
            return None
        spec = desc.schedule_spec(p, S_loc=64, window=96)
        sched = pairs(k.check_schedule_spec(spec, p, subject=name))
        audit = k.audit_strategy(desc, B=2, S=64 * p, Hq=8, Hkv=2, D=64, P=p,
                                 bytes_per_elem=2, travel_dtype="bfloat16", window=96)
        return sched, pairs(audit), k.audit_schedule(spec, p, k.DIMS)[:2]

    j, t = both(run)
    assert t == j
    assert t is None or t[:2] == ([], [])


TOPO_NAMES = ("nvlink_pod(4)", "nvlink_pod(8)", "two_pods(4)", "half_duplex_pod(8)")


def _topo(k, name):
    fn, n = name[:-1].split("(")
    return getattr(k, fn)(int(n))


@pytest.mark.parametrize("name", sorted(t_strat.available_strategies()))
@pytest.mark.parametrize("topo", TOPO_NAMES)
def test_registered_strategies_topo_clean_as_in_jax(name, topo):
    def run(k):
        findings = k.check_strategy_topology(
            k.get_strategy(name), _topo(k, topo), B=2, S_loc=64, Hq=8, Hkv=2, D=64,
            bytes_per_elem=2, travel_dtype="bfloat16", window=96)
        return None if findings is None else pairs(findings)

    j, t = both(run)
    assert t == j and t in (None, [])


# ---------------------------------------------------------------------------
# schedule mutations: each caught with the reference's rule IDs
# ---------------------------------------------------------------------------


def zero_shift(k):
    s = k.ring_spec(P)
    step = k.Step(k.Send(("kv",), 0), k.Compute("q", ("kv",), "p"), k.Merge("acc", "p"))
    return replace(s, schedule=k.Schedule(prologue=(step,), body=step, trips=P - 2,
                                          epilogue=s.schedule.epilogue,
                                          static=s.schedule.static))


def colliding_sends(k):
    s = k.ring_spec(P)
    step = k.Step(k.Send(("kv",), 1), k.Send(("kv",), 2, into=("kv",)),
                  k.Compute("q", ("kv",), "p"), k.Merge("acc", "p"))
    return replace(s, schedule=k.Schedule(prologue=(step,), body=step, trips=P - 2,
                                          epilogue=s.schedule.epilogue,
                                          static=s.schedule.static))


def flipped_shift(k):
    s = k.token_ring_bidir_spec(P)
    body = k.Step(k.Send(("qa",), 1), k.Send(("aa",), 1), k.Send(("qb",), -1),
                  k.Send(("ab",), 1),  # flipped: +1, should be -1
                  k.Compute("qa", ("kv",), "pa"), k.Compute("qb", ("kv",), "pb"),
                  k.Merge("aa", "pa"), k.Merge("ab", "pb"))
    return replace(s, schedule=replace(s.schedule, body=body))


def double_merge(k):
    s = k.ring_spec(P)
    body = k.Step(k.Send(("kv",), 1), k.Compute("q", ("kv",), "p"), k.Merge("acc", "p"),
                  k.Merge("acc", "p"))
    return replace(s, schedule=k.Schedule(prologue=(s.schedule.prologue[0],), body=body,
                                          trips=P - 2, epilogue=s.schedule.epilogue,
                                          static=s.schedule.static))


def shrunk_buffer(k):
    s = k.token_ring_bidir_spec(P)
    return replace(s, buffers={**s.buffers, "aa": replace(s.buffers["aa"], frac=0.25)})


def dropped_send(k):
    s = k.ring_bidir_spec(P)
    body = k.Step(k.Send(("kva",), 1), k.Compute("q", ("kva", "kvb"), "p"), k.Merge("acc", "p"))
    return replace(s, schedule=replace(s.schedule, prologue=(body,), body=body))


def short_trip(k):
    s = k.ring_spec(P)
    return replace(s, schedule=replace(s.schedule, trips=P - 3))


def unknown_read(k):
    s = k.ring_spec(P)
    step = k.Step(k.Send(("kv",), 1), k.Compute("q", ("mystery",), "p"), k.Merge("acc", "p"))
    return replace(s, schedule=k.Schedule(prologue=(step,), body=step, trips=P - 2,
                                          epilogue=s.schedule.epilogue,
                                          static=s.schedule.static))


def passkv_double_send(k):
    s = k.passkv_ring_spec(P)
    step = k.Step(k.Send(("kva",), 1), k.Send(("kva",), 2, into=("kva",)),
                  k.Send(("kvb",), -1), k.Compute("q", ("kva", "kvb"), "p"),
                  k.Merge("acc", "p"))
    return replace(s, schedule=replace(s.schedule, prologue=(step,), body=step))


def passkv_missing_hop(k):
    s = k.passkv_ring_spec(P)
    step = k.Step(k.Send(("kva",), 1), k.Compute("q", ("kva", "kvb"), "p"), k.Merge("acc", "p"))
    return replace(s, schedule=replace(s.schedule, prologue=(step,), body=step))


def passq_desynced_acc(k):
    s = k.passq_ring_spec(P)
    body = k.Step(k.Send(("q",), 1), k.Send(("acc",), -1), k.Compute("q", ("kv",), "p"),
                  k.Merge("acc", "p"))
    return replace(s, schedule=replace(s.schedule, body=body))


MUTATIONS = {
    "zero_shift": (zero_shift, {"SCHED-DEADLOCK"}),
    "colliding_sends": (colliding_sends, {"SCHED-UNMATCHED"}),
    "flipped_shift": (flipped_shift, {"SCHED-MERGE-MISMATCH"}),
    "double_merge": (double_merge, {"SCHED-DUP-COVER"}),
    "shrunk_buffer": (shrunk_buffer, {"SCHED-SHAPE"}),
    "dropped_send": (dropped_send, {"SCHED-COVERAGE"}),
    "short_trip": (short_trip, {"SCHED-COVERAGE"}),
    "unknown_read": (unknown_read, {"SCHED-VALIDATE"}),
    "passkv_double_send": (passkv_double_send, {"SCHED-UNMATCHED"}),
    "passkv_missing_hop": (passkv_missing_hop, {"SCHED-COVERAGE"}),
    "passq_desynced_acc": (passq_desynced_acc, {"SCHED-MERGE-MISMATCH"}),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_schedule_mutation_caught_as_in_jax(name):
    build, expected = MUTATIONS[name]

    def run(k):
        mut = build(k)
        return pairs(k.check_schedule_spec(mut, P, subject=name)), k.audit_schedule(
            mut, P, k.DIMS)[:2]

    j, t = both(run)
    assert t == j
    assert expected <= {rule for rule, _ in t[0]}, t[0]
    if name == "zero_shift":
        assert {rule for rule, _ in t[0]} == expected


def test_dropped_send_changes_the_audited_bytes():
    k = PKGS["port"]
    mutated = k.audit_schedule(dropped_send(k), P, k.DIMS)[:2]
    assert mutated != k.audit_schedule(k.ring_bidir_spec(P), P, k.DIMS)[:2]


@pytest.mark.parametrize("p", [2, 3, 5])
def test_faithful_and_window_walks_cover_small_rings(p):
    def run(k):
        out = [pairs(k.check_schedule_spec(k.token_ring_faithful_spec(p), p))]
        for w in (40, 96, 500):
            out.append(pairs(k.check_schedule_spec(k.window_spec(p, S_loc=64, window=w), p)))
        return out

    j, t = both(run)
    assert t == j == [[]] * 4


# ---------------------------------------------------------------------------
# comm audit mutations
# ---------------------------------------------------------------------------


def test_unspeced_buffer_is_flagged_as_in_jax():
    def run(k):
        s = k.ring_spec(P)
        buffers = dict(s.buffers)
        del buffers["kv"]
        fwd, bwd, findings = k.audit_schedule(replace(s, buffers=buffers), P, k.DIMS)
        return fwd, bwd, pairs(findings)

    j, t = both(run)
    assert t == j and {rule for rule, _ in t[2]} == {"COMM-UNSPECED"}


def test_audit_direction_tie_uses_declared_sign_as_in_jax():
    def run(k):
        fwd, bwd, findings = k.audit_schedule(k.ring_bidir_spec(2), 2, k.DIMS)
        return fwd, bwd, pairs(findings)

    j, t = both(run)
    assert t == j and t[2] == [] and t[0] == t[1] > 0


def test_comm_drift_on_trip_change_as_in_jax():
    def run(k):
        mut = short_trip(k)
        desc = replace(k.get_strategy("ring"), schedule_spec=lambda p, **_: mut)
        return pairs(k.audit_strategy(desc, B=2, S=64 * P, Hq=8, Hkv=2, D=64, P=P,
                                      bytes_per_elem=2))

    j, t = both(run)
    assert t == j and {rule for rule, _ in t} == {"COMM-DRIFT"}


# ---------------------------------------------------------------------------
# topology mutations
# ---------------------------------------------------------------------------


def test_topo_oversubscribed_two_device_ring_as_in_jax():
    j, t = both(lambda k: pairs(k.check_spec_topology(
        k.token_ring_bidir_spec(2), k.DIMS, k.nvlink_pod(2), subject="p2")[1]))
    assert t == j and {rule for rule, _ in t} == {"TOPO-OVERSUBSCRIBED"}


def test_topo_half_duplex_claim_caught_as_in_jax():
    def run(k):
        spec, topo = k.token_ring_bidir_spec(8), k.half_duplex_pod(8)
        claimed = k.check_spec_topology(spec, k.DIMS, topo, assume_bidir=True, subject="hd")
        honest = k.check_spec_topology(spec, k.DIMS, topo, subject="hd")
        return pairs(claimed[1]), pairs(honest[1])

    j, t = both(run)
    assert t == j and {rule for rule, _ in t[0]} == {"TOPO-HALF-DUPLEX"} and t[1] == []


def _hier2d_cost_p8(k):
    d = k.DIMS
    return k.hier2d_comm_cost(d.B, d.S_loc * 8, d.Hq, d.Hkv, d.D, 8,
                              bytes_per_elem=d.bytes_per_elem, travel_dtype="float32", n_pods=2)


def test_topo_cross_pod_extra_kv_exchange_as_in_jax():
    def run(k):
        spec = k.hier2d_spec(8, n_pods=2)
        steps = list(spec.schedule.prologue)
        half = len(steps) // 2
        steps[half] = k.Step(k.Send(("kv0",), 1, into=("kv1",), axis="pod"), *steps[half].ops)
        mut = replace(spec, schedule=k.Schedule(prologue=tuple(steps)))
        _, findings = k.check_spec_topology(mut, k.DIMS, k.two_pods(4),
                                            cost=_hier2d_cost_p8(k), subject="xpod")
        detail = next(f.detail for f in findings if f.rule == "TOPO-CROSS-POD")
        return pairs(findings), f"steps [0, {half}]" in detail

    j, t = both(run)
    assert t == j and t[1]


def test_topo_cost_drift_on_underdeclared_intra_bytes_as_in_jax():
    def run(k):
        cost = _hier2d_cost_p8(k)
        intra, inter = cost.links
        lied = replace(cost, links=(replace(intra, fwd_bytes=intra.fwd_bytes / 2), inter))
        return pairs(k.check_spec_topology(k.hier2d_spec(8, n_pods=2), k.DIMS, k.two_pods(4),
                                           cost=lied, subject="drift")[1])

    j, t = both(run)
    rules = {rule for rule, _ in t}
    assert t == j and "TOPO-COST-DRIFT" in rules and "TOPO-CROSS-POD" not in rules


def test_topo_ledger_matches_symbolic_audit_as_in_jax():
    def run(k):
        spec = k.hier2d_spec(8, n_pods=2)
        fwd, bwd, findings = k.audit_schedule(spec, 8, k.DIMS)
        dirs = k.build_ledger(spec, k.DIMS, k.two_pods(4)).lane_dir_totals()
        return (fwd, bwd, pairs(findings), sum(d["fwd"] for d in dirs.values()),
                sum(d["bwd"] for d in dirs.values()))

    j, t = both(run)
    assert t == j and t[2] == [] and t[3:] == (8 * t[0], 8 * t[1])


def test_topo_ledger_json_as_in_jax():
    def run(k):
        ledger, findings = k.check_spec_topology(k.token_ring_bidir_spec(4), k.DIMS,
                                                 k.nvlink_pod(4), subject="json")
        return ledger.to_json(), pairs(findings)

    j, t = both(run)
    assert t == j and t[1] == []
    blob = t[0]
    assert blob["topology"] == "nvlink_pod(4)" and len(blob["links"]) == 4
    assert all(link["fwd_bytes"] == link["bwd_bytes"] > 0 for link in blob["links"])


# ---------------------------------------------------------------------------
# properties (derandomised: a hypothesis test that draws new examples each
# run is a flake)
# ---------------------------------------------------------------------------


def _rotation_spec(k, p, shift):
    final = k.Step(k.Compute("q", ("kv",), "p"), k.Merge("acc", "p"))
    step = k.Step(k.Send(("kv",), shift), k.Compute("q", ("kv",), "p"), k.Merge("acc", "p"))
    return k.ScheduleSpec(
        schedule=k.Schedule(prologue=(step,), body=step, trips=p - 2, epilogue=(final,),
                            static=frozenset({"q"})),
        buffers={"q": k.BufferSpec(role="q", positions=True),
                 "kv": k.BufferSpec(role="kv", heads="kv", positions=True),
                 "acc": k.BufferSpec(role="acc", lse=True, bound_q="q")},
        out=("acc",),
    )


@settings(max_examples=60, deadline=None, derandomize=True)
@given(p=st.integers(2, 12), shift=st.integers(-12, 12))
def test_rotation_schedule_clean_iff_generator(p, shift):
    j, t = both(lambda k: pairs(k.check_schedule_spec(_rotation_spec(k, p, shift), p)))
    assert t == j
    rules = {rule for rule, _ in t}
    if shift % p == 0:
        assert "SCHED-DEADLOCK" in rules
    elif math.gcd(shift, p) == 1:
        assert rules == set()
    else:
        assert "SCHED-COVERAGE" in rules


@settings(max_examples=40, deadline=None, derandomize=True)
@given(p=st.integers(3, 10), trips=st.integers(0, 12))
def test_ring_trip_count_clean_iff_exact(p, trips):
    def run(k):
        spec = k.ring_spec(p)
        return pairs(k.check_schedule_spec(replace(spec, schedule=replace(spec.schedule,
                                                                           trips=trips)), p))

    j, t = both(run)
    assert t == j
    if trips == p - 2:
        assert t == []
    else:
        assert {rule for rule, _ in t} & {"SCHED-COVERAGE", "SCHED-DUP-COVER"}


@settings(max_examples=40, deadline=None, derandomize=True)
@given(p=st.sampled_from([2, 3, 4, 8]), b=st.integers(1, 4),
       s_loc=st.sampled_from([32, 64, 128]), heads=st.sampled_from([(4, 4), (8, 2), (16, 16)]),
       bpe=st.sampled_from([1, 2, 4]))
def test_audit_matches_cost_models_everywhere(p, b, s_loc, heads, bpe):
    hq, hkv = heads
    for name in ("tokenring", "tokenring_faithful", "ring", "ring_bidir"):
        findings = t_audit.audit_strategy(
            t_strat.get_strategy(name), B=b, S=s_loc * p, Hq=hq, Hkv=hkv, D=64, P=p,
            bytes_per_elem=bpe, travel_dtype="float32")
        assert findings == [], [str(f) for f in findings]


# ---------------------------------------------------------------------------
# the audit against the bytes the virtual ring is handed
# ---------------------------------------------------------------------------

LEDGER_CASES = [(name, p, travel) for name in ("tokenring", "ring", "ring_bidir", "window")
                for p in (4, 8) for travel in ("float32", "bfloat16")]


@pytest.mark.parametrize("case", LEDGER_CASES, ids=["-".join(map(str, c)) for c in LEDGER_CASES])
def test_audit_equals_the_virtual_rings_ledger(case):
    """One forward pass through the port's virtual ring on the CPU: the
    per-direction bytes the audit walks out of the strategy's schedule equal
    the bytes the transport is handed, exactly, and the position rows the
    audit adds with ``include_positions`` equal the ring's position bytes."""
    name, p, travel = case
    dtype = torch.float32 if travel == "float32" else torch.bfloat16
    B, S_loc, Hq, Hkv, D = 2, 16, 4, 2, 16
    window = 24 if name == "window" else None
    S = S_loc * p
    ring = VirtualRing(p, "cpu")
    layout = "contig" if name == "window" else "zigzag"
    pctx = tapi.ParallelContext(device="cpu", impl="torch", sp_degree=p, strategy=name,
                                travel_dtype=travel, ring=ring, layout=layout)
    gen = torch.Generator().manual_seed(p)
    q = torch.randn(B, S, Hq, D, generator=gen).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=gen).to(dtype)
    pos = torch.arange(S, dtype=torch.int32)
    with torch.no_grad():
        tapi.sp_attention(q, k, k, pos, pos, pctx=pctx, window=window)
    spec = t_strat.get_strategy(name).schedule_spec(p, S_loc=S_loc, window=window)
    dims = t_audit.AuditDims(B=B, S_loc=S_loc, Hq=Hq, Hkv=Hkv, D=D,
                             bytes_per_elem=q.element_size(),
                             travel_bytes=t_strat.itemsize(travel))
    fwd, bwd, findings = t_audit.audit_schedule(spec, p, dims)
    assert findings == []
    assert ring.link_bytes == {"fwd": fwd, "bwd": bwd} and fwd + bwd > 0
    fwd_pos, bwd_pos, _ = t_audit.audit_schedule(spec, p, dims, include_positions=True)
    assert ring.position_bytes == {"fwd": fwd_pos - fwd, "bwd": bwd_pos - bwd}
    assert t_audit.audit_strategy(t_strat.get_strategy(name), B=B, S=S, Hq=Hq, Hkv=Hkv, D=D,
                                  P=p, bytes_per_elem=q.element_size(), travel_dtype=travel,
                                  window=window) == []


# ---------------------------------------------------------------------------
# the precondition catalog: the same words statically and at run time
# ---------------------------------------------------------------------------


def test_catalog_messages_are_the_runtime_errors():
    import repro.analysis.preconditions as jpre
    from repro_torch.kernels import ops

    msg = tpre.check_even_split(65, what="Q block", who="token_ring variant='bidir'",
                                alternative="variant='faithful'")
    assert "token_ring variant='bidir' splits the local Q block" in msg
    with pytest.raises(ValueError, match="needs an even local length"):
        tpre.require(msg)
    assert tpre.check_even_split(64, what="x", who="y", alternative="z") is None

    msg = tpre.check_zigzag_divisible(100, 4)
    assert "divisible by 2P" in msg and "multiple of 8" in msg
    assert tpre.check_zigzag_divisible(96, 4) is None

    assert tpre.check_tile_divisible is ops.check_tile_divisible
    assert tpre.check_tile_divisible(1024, 512) is None
    assert "no power-of-two tile" in tpre.check_tile_divisible(1038, 512)
    for s, b in ((1038, 512), (1024, 512), (100, 64), (12, 512)):
        assert tpre.check_tile_divisible(s, b) == jpre.check_tile_divisible(s, b)
    with pytest.raises(ValueError, match="no power-of-two tile"):
        ops.pick_block(1038, 512)

    assert tpre.finding("PRE-TILE-DIV", "s", None) == []
    got = tpre.finding("PRE-TILE-DIV", "s", tpre.check_tile_divisible(1038, 512))
    want = jpre.finding("PRE-TILE-DIV", "s", jpre.check_tile_divisible(1038, 512))
    assert [(f.rule, f.subject, f.detail) for f in got] == \
        [(f.rule, f.subject, f.detail) for f in want]


# ---------------------------------------------------------------------------
# report plumbing
# ---------------------------------------------------------------------------


def test_finding_requires_known_rule():
    with pytest.raises(ValueError, match="unknown rule"):
        Finding("NOT-A-RULE", "s", "d")


def test_report_render_and_ok():
    r = Report()
    r.note_checked("schedule", 3)
    assert r.ok and "OK: 0 findings" in r.render()
    r.extend([Finding("SCHED-DEADLOCK", "subj", "det")])
    assert not r.ok and "FAIL: 1 finding(s)" in r.render()
    assert set(r.by_rule()) == {"SCHED-DEADLOCK"}


def test_rule_catalog_is_the_reference_with_the_hopper_kernel_rules():
    from repro.analysis.report import RULES as JRULES

    hopper = {"KERN-SMEM", "KERN-SPILL", "KERN-WGMMA-SERIAL", "KERN-CLUSTER"}
    assert set(RULES) == (set(JRULES) - {"KERN-VMEM", "OVLP-BLOCKED"}) | hopper
    for rule in set(RULES) - hopper - {"KERN-PAGED-BOUNDS", "KERN-PAGED-SENTINEL"}:
        assert RULES[rule] == JRULES[rule], rule


# ---------------------------------------------------------------------------
# the CLI gate
# ---------------------------------------------------------------------------


def test_analyze_cli_clean_on_the_cpu(capsys):
    from repro_torch.launch.analyze import main

    assert main(["--all", "--device", "cpu", "--verbose", "--fail-on-findings"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK: 0 findings")
    assert "ptxas rules: skipped" in out
    for name in ("schedule", "comm", "kernel", "topo", "tile_skip", "kernel_ragged_tail"):
        assert f"checked {name}: " in out


def test_analyze_cli_fails_on_an_injected_finding(monkeypatch, capsys):
    from repro_torch.launch import analyze

    past = analyze.admitted_lengths()["fwd_wgmma[D=256]"] + 64
    monkeypatch.setattr(analyze, "FLASH_CALLS", analyze.FLASH_CALLS + (
        ("too long", torch.bfloat16, 256, 1, 64, past, 1, 1, False),))
    assert analyze.main(["--device", "cpu", "--passes", "kernel", "--fail-on-findings"]) == 1
    out = capsys.readouterr().out
    assert "rule KERN-SMEM: 1 finding(s)" in out and "FAIL: 1 finding(s)" in out
    assert analyze.main(["--device", "cpu", "--passes", "kernel"]) == 0


def test_analyze_cli_json_and_passes(capsys):
    import json

    from repro_torch.launch.analyze import main, run_analysis

    assert main(["--device", "cpu", "--passes", "schedule,comm", "--json"]) == 0
    blob = json.loads(capsys.readouterr().out)
    assert blob["findings"] == [] and set(blob["checked"]) == {"schedule", "comm"}
    report = run_analysis(passes=("topo",), device="cpu")
    assert report.ok and report.checked["topo"] > 0
    with pytest.raises(ValueError, match="unknown passes"):
        run_analysis(passes=("overlap",), device="cpu")


def test_analyze_cli_on_cuda_without_a_card_fails(monkeypatch):
    from repro_torch.launch import analyze

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--all", "--fail-on-findings"], ["--passes", "schedule"]):
        with pytest.raises(SystemExit) as e:
            analyze.main(argv)
        assert e.value.code not in (0, None) and "needs a CUDA device" in str(e.value.code)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        analyze.run_analysis(device="cuda")

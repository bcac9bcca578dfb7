"""The port's serving resilience layer against the JAX package: fault plans,
the degrade ladder, quarantine and retry, the cache auditor and serving
snapshots (the cases of ``tests/test_resilience.py``, case for case).

Each engine case runs the port's engine (plain versions, float32, on the
CPU) and the JAX engine (``impl="xla"``) on the same workload with the same
parameters (``from_jax_params``) and the same fault plan: the ``fired``
logs, the counters (all but the timing-driven ``straggler_events``), the
ladder, the auditor's codes and every request's tokens must be equal.  The
chaos property is derandomised: a fixed list of seeded plans, each held
against the JAX engine's run of the same plan.
"""

import json

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.models import build_model as jbuild
from repro.serving import resilience as jres
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import resilience as tres
from repro_torch.serving.engine import ServingEngine as TEngine

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
            vocab_size=97)
_CTX: dict = {}


def _ctx():
    """Module-cached tiny model in both packages (the engines never mutate
    the parameters)."""
    if not _CTX:
        jcfg = JARCHS["qwen3-1.7b"].reduced(**TINY)
        tcfg = TARCHS["qwen3-1.7b"].reduced(**TINY)
        jb = jbuild(jcfg, JPctx(mesh=None, impl="xla"))
        jparams = jb.init(jax.random.PRNGKey(0))
        tb = tbuild(tcfg, TPctx(impl="torch", device="cpu"))
        tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        _CTX["all"] = (jb, jparams, tb, tparams)
    return _CTX["all"]


_RNG = np.random.default_rng(11)
WORKLOADS = {"standard": [list(_RNG.integers(1, 90, n)) for n in (12, 9, 15)]}
_BASE = list(_RNG.integers(1, 90, 25))
WORKLOADS["cow"] = [_BASE, _BASE[:20] + [(t + 1) % 90 + 1 for t in _BASE[20:]]]
WORKLOADS["tight"] = [_BASE, list(_BASE)]
ENGINE_KW = dict(max_batch=2, max_len=64, prefill_chunk=8, page_size=8, max_pages=32,
                 prefix_cache=True, max_retries=5, retry_backoff=1)
_KW_OVERRIDES = {"tight": {"max_pages": 8}, "cow": {"max_batch": 1}}
_N_NEW = {"standard": 5, "cow": 6, "tight": 20}
PKGS = {"torch": tres, "jax": jres}


def _engine(pkg, plan=None, **kw):
    jb, jparams, tb, tparams = _ctx()
    if pkg == "jax":
        return JEngine(jb, jparams, fault_plan=plan, **kw)
    return TEngine(tb, tparams, fault_plan=plan, device="cpu", **kw)


def _run_workload(pkg, name, specs=None, plan_kw=None, **overrides):
    """One workload through ``pkg``'s engine under a plan of ``specs``."""
    kw = dict(ENGINE_KW, **_KW_OVERRIDES.get(name, {}), **overrides)
    plan = None
    if specs is not None or plan_kw:
        mod = PKGS[pkg]
        plan = mod.FaultPlan([mod.FaultSpec(*s) for s in specs or ()], **(plan_kw or {}))
    eng = _engine(pkg, plan, **kw)
    reqs = [eng.submit(p, max_new_tokens=_N_NEW[name]) for p in WORKLOADS[name]]
    eng.run()
    return eng, {r.uid: r for r in reqs}, plan


def _record(eng, reqs, plan):
    counters = {k: v for k, v in eng.counters.items() if k != "straggler_events"}
    return {"tokens": {uid: list(r.output) for uid, r in reqs.items()},
            "status": {uid: (r.status, r.retries) for uid, r in reqs.items()},
            "fired": list(plan.fired) if plan is not None else [],
            "counters": counters, "ladder": eng.ladder.export_state(),
            "violations": [v.split(":")[0] for v in eng.auditor.violations()],
            "prefix": eng.prefix.stats() if eng.prefix is not None else None}


def _both(name, specs=None, plan_kw=None, **overrides):
    """The port's run and the JAX run of one case; asserts they agree."""
    out = {}
    for pkg in ("torch", "jax"):
        eng, reqs, plan = _run_workload(pkg, name, specs, plan_kw, **overrides)
        out[pkg] = (eng, reqs, _record(eng, reqs, plan))
    assert out["torch"][2] == out["jax"][2]
    return out["torch"]


_ORACLE: dict = {}


def _oracle(name):
    if name not in _ORACLE:
        eng, reqs, rec = _both(name)
        assert all(r.status == "done" for r in reqs.values())
        assert rec["violations"] == []
        _ORACLE[name] = rec["tokens"]
    return _ORACLE[name]


# ---------------------------------------------------------------------------
# FaultPlan / DegradeLadder units, against the JAX objects
# ---------------------------------------------------------------------------


def test_fault_plan_scheduled_counts_and_uid_filters():
    fired = {}
    for pkg, mod in PKGS.items():
        plan = mod.FaultPlan([mod.FaultSpec("sample", nth=2, times=2),
                              mod.FaultSpec("alloc", uid=7, nth=0)])
        hits = []
        for _ in range(6):
            try:
                plan.fire("sample")
            except mod.InjectedFault as e:
                hits.append(e.nth)
        assert hits == [2, 3]
        plan.fire("alloc", uid=3)
        with pytest.raises(mod.InjectedFault) as ei:
            plan.fire("alloc", uid=7)
        assert ei.value.uid == 7 and isinstance(ei.value, mod.ServingFault)
        fired[pkg] = plan.fired
    assert fired["torch"] == fired["jax"] == [("sample", 2, None), ("sample", 3, None),
                                             ("alloc", 1, 7)]


@pytest.mark.parametrize("seed", [5, 6])
def test_fault_plan_bernoulli_matches_jax_per_seed(seed):
    def fired_mask(mod):
        p = mod.FaultPlan.bernoulli(0.3, seed=seed, points=("decode_once", "sample"))
        out = []
        for i in range(64):
            try:
                p.fire(("decode_once", "sample", "admit")[i % 3], uid=i % 4 or None)
                out.append(False)
            except mod.InjectedFault:
                out.append(True)
        return out, p.fired

    got, want = fired_mask(tres), fired_mask(jres)
    assert got == want and any(got[0]) and not all(got[0])
    assert fired_mask(tres) == got  # repeatable


def test_fault_plan_validates_inputs():
    with pytest.raises(ValueError, match="unknown tick point"):
        tres.FaultSpec("defrag")
    with pytest.raises(ValueError, match="nth"):
        tres.FaultSpec("sample", nth=-1)
    with pytest.raises(ValueError, match="rate"):
        tres.FaultPlan(rate=1.0)
    assert tres.TICK_POINTS == jres.TICK_POINTS


def test_degrade_ladder_escalates_and_self_heals():
    states = {}
    for pkg, mod in PKGS.items():
        lad = mod.DegradeLadder(escalate_after=2, window=8, cooldown=4)
        assert lad.name == "normal" and lad.allow_splice and lad.allow_admission
        levels = []
        for t in range(1, 7):
            lad.record_fault(t)
            levels.append((lad.level, lad.allow_splice, lad.allow_share, lad.allow_admission))
        for t in range(7, 11):
            lad.record_clean(t)
        levels.append(lad.level)
        for t in range(11, 30):
            lad.record_clean(t)
        levels.append(lad.level)
        lad2 = mod.DegradeLadder(escalate_after=2, window=4, cooldown=100)
        lad2.record_fault(1)
        lad2.record_fault(50)
        levels.append(lad2.level)
        blob = json.loads(json.dumps(lad.export_state()))
        lad3 = mod.DegradeLadder()
        lad3.load_state(blob)
        states[pkg] = (levels, lad3.export_state())
    assert states["torch"] == states["jax"]
    assert states["torch"][0][5] == (3, False, False, False)
    assert states["torch"][0][6:] == [2, 0, 0]


# ---------------------------------------------------------------------------
# chaos: one injected fault per tick point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload,spec", [
    ("standard", ("admit", 1)),
    ("standard", ("alloc", 1)),
    ("standard", ("prefill_tick", 1)),
    ("standard", ("decode_once", 2)),
    ("standard", ("sample", 3)),
    ("cow", ("cow", 0)),
    ("tight", ("evict", 0)),
], ids=lambda v: v[0] if isinstance(v, tuple) else v)
def test_single_fault_survived_bitwise(workload, spec):
    want = _oracle(workload)
    eng, reqs, rec = _both(workload, [spec])
    assert rec["fired"], f"the planned {spec[0]} invocation never happened"
    assert all(r.status == "done" for r in reqs.values())
    assert rec["tokens"] == want and rec["violations"] == []
    assert eng.counters["faults"] >= 1
    assert eng.stats()["audits"]["post_recovery"] >= 1
    assert eng.stats()["audits"]["post_recovery_violations"] == 0
    if spec[0] in ("admit", "alloc", "sample", "cow", "evict"):
        assert eng.counters["quarantines"] >= 1


def test_repeated_faults_bounded_backoff_then_permanent_failure():
    want = _oracle("standard")
    eng, reqs, rec = _both("standard", [("sample", 0, 99, 2)], max_retries=2)
    bad = reqs[2]
    assert bad.status == "failed" and bad.retries == 3
    assert "injected fault at sample" in bad.error and bad in eng.done
    for uid, r in reqs.items():
        if uid != 2:
            assert r.status == "done" and list(r.output) == want[uid]
    assert eng.counters["failures"] == 1 and eng.counters["quarantines"] == 3
    assert rec["violations"] == [] and eng.stats()["failed_requests"] == 1


def test_transient_faults_retry_to_identical_output():
    want = _oracle("standard")
    eng, reqs, rec = _both("standard", [("sample", 0, 2, 1)], max_retries=5)
    assert reqs[1].status == "done" and reqs[1].retries == 2
    assert rec["tokens"] == want and rec["violations"] == []


# ---------------------------------------------------------------------------
# the ladder in the engine
# ---------------------------------------------------------------------------


def test_persistent_faults_climb_to_shedding():
    got = {}
    for pkg, mod in PKGS.items():
        plan = mod.FaultPlan([mod.FaultSpec("decode_once", nth=0, times=9)])
        eng = _engine(pkg, plan, **ENGINE_KW)
        req = eng.submit(WORKLOADS["standard"][0], max_new_tokens=4)
        eng.run()
        assert req.status == "done" and list(req.output) == _oracle("standard")[1][:4]
        assert eng.ladder.name == "shed" and eng.ladder.escalations == 3
        with pytest.raises(mod.LoadShedError, match="shed"):
            eng.submit([1, 2, 3])
        got[pkg] = (list(req.output), eng.counters["load_shed"], eng.counters["faults"],
                    eng.counters["recoveries"], plan.fired)
    assert got["torch"] == got["jax"]
    assert got["torch"][1:4] == (1, 9, 9)


def test_ladder_gates_prefix_splicing_then_sharing():
    got = {}
    for pkg in PKGS:
        prompt = WORKLOADS["cow"][0]  # 25 tokens: 3 full prefix pages
        eng = _engine(pkg, **ENGINE_KW)
        eng.submit(prompt, max_new_tokens=4)
        eng.run()
        assert len(eng.prefix.pages) == 3
        lookups = eng.prefix.lookup_tokens
        cold = eng.counters["prefill_tokens"]
        eng.ladder.level = 1  # no_splice: no lookup, completed prefills still register
        eng.submit(prompt, max_new_tokens=4)
        eng.run()
        assert eng.prefix.lookup_tokens == lookups
        assert eng.counters["prefill_tokens"] == 2 * cold
        eng.ladder.level = 2  # no_share: nothing new registered either
        eng.submit([91, 92, 93, 94, 95, 96] * 4, max_new_tokens=4)
        eng.run()
        assert len(eng.prefix.pages) == 3 and eng.auditor.violations() == []
        got[pkg] = (sorted(eng.prefix.pages), eng.prefix.stats(),
                    [list(r.output) for r in eng.done])
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# the cache auditor; recovery through snapshots
# ---------------------------------------------------------------------------


def _mid_flight_engine(pkg, tmp_path=None, **overrides):
    kw = dict(ENGINE_KW)
    if tmp_path is not None:
        kw["snapshot_dir"] = str(tmp_path)
    kw.update(overrides)
    eng = _engine(pkg, **kw)
    for p in WORKLOADS["standard"]:
        eng.submit(p, max_new_tokens=_N_NEW["standard"])
    eng.run(max_steps=3)  # prompts part-prefilled: genuinely mid-flight
    assert any(s is not None for s in eng.slots)
    return eng


def _corruptions(eng):
    """Apply each corruption class in turn; the auditor's codes after each."""
    codes = lambda: [v.split(":")[0] for v in eng.auditor.violations()]  # noqa: E731
    out = [codes()]
    occupied = next(i for i, s in enumerate(eng.slots) if s is not None)
    page = int(eng._bt[occupied, 0])
    eng.alloc._free.append(page)
    eng.alloc._free_set.add(page)
    out.append(codes())
    eng.alloc._free.remove(page)
    eng.alloc._free_set.discard(page)
    keep = eng._bt[occupied].copy()
    eng._bt[occupied, -1] = eng.max_pages + 3
    out.append(codes())
    eng._bt[occupied] = keep
    empty = next((i for i, s in enumerate(eng.slots) if s is None), None)
    if empty is not None:
        eng._bt[empty, 0] = page
        out.append(codes())
        eng._bt[empty, 0] = eng.NULL
    eng.slots[occupied]._cached += 1
    out.append(codes())
    eng.slots[occupied]._cached -= 1
    key = b"\x00" * 32
    eng.prefix._key_of[page] = key
    eng.prefix._page_of[key] = page
    eng.prefix._refs[page] = 5
    eng.prefix._tokens[key] = (0,)
    eng.prefix._parent[key] = b""
    out.append(codes())
    return out


def test_auditor_flags_each_violation_class():
    got = {pkg: _corruptions(_mid_flight_engine(pkg)) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    codes = got["torch"]
    assert codes[0] == [] and {"FREE-MAPPED", "ACCOUNT"} <= set(codes[1])
    assert "BT-RANGE" in codes[2] and "LEN-MISMATCH" in codes[-2]
    assert "REF-MISMATCH" in codes[-1]
    eng = _mid_flight_engine("torch")
    _corruptions(eng)
    with pytest.raises(tres.IntegrityError, match="violation"):
        eng.auditor.check()


def test_integrity_error_without_snapshot_is_fatal():
    eng = _mid_flight_engine("torch", audit_every=1)
    page = next(int(p) for p in eng._bt.ravel() if p != eng.NULL)
    eng.alloc._free.append(page)
    eng.alloc._free_set.add(page)
    with pytest.raises(tres.IntegrityError, match="FREE-MAPPED"):
        eng.run()


def test_integrity_error_restores_snapshot_and_completes(tmp_path):
    want = _oracle("standard")
    got = {}
    for pkg in PKGS:
        eng = _mid_flight_engine(pkg, tmp_path / pkg, audit_every=1)
        eng.snapshot()
        page = next(int(p) for p in eng._bt.ravel() if p != eng.NULL)
        eng.alloc._free.append(page)
        eng.alloc._free_set.add(page)
        done = eng.run()
        assert eng.counters["integrity_errors"] >= 1 and eng.counters["snapshots"] == 1
        by_uid = {r.uid: r for r in done}
        assert {u: list(r.output) for u, r in by_uid.items()} == want
        assert all(r.status == "done" for r in by_uid.values())
        assert eng.auditor.violations() == []
        got[pkg] = {k: v for k, v in eng.counters.items() if k != "straggler_events"}
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# snapshots: kill and restart, token-exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_snapshot_kill_restart_token_exact(temperature, tmp_path):
    """A killed engine restarted from its snapshot emits exactly the tokens
    of an engine that never stopped: at temperature 0 the JAX engine's, at
    temperature 1 the port's own uninterrupted run (the generator's state
    rides in the sidecar)."""
    _, _, tb, tparams = _ctx()
    kw = dict(ENGINE_KW, temperature=temperature, seed=5)
    ref = _engine("torch", **kw)
    for p in WORKLOADS["standard"]:
        ref.submit(p, max_new_tokens=_N_NEW["standard"])
    want = {r.uid: list(r.output) for r in ref.run()}
    if temperature == 0.0:
        assert want == _oracle("standard")
    eng = _mid_flight_engine("torch", tmp_path, temperature=temperature, seed=5)
    eng.run(max_steps=3)  # some tokens sampled before the snapshot
    step = eng.snapshot()
    assert eng._ckpt.latest_step() == step
    del eng  # the kill
    eng2 = TEngine.from_snapshot(tb, tparams, str(tmp_path), device="cpu")
    eng2.auditor.check()
    done = eng2.run()
    assert {r.uid: list(r.output) for r in done} == want
    assert all(r.status == "done" for r in done) and eng2.auditor.violations() == []
    if temperature == 0.0:
        # the prefix index survived with its chain keys: a warm repeat hits
        prefill_after = eng2.counters["prefill_tokens"]
        warm = eng2.submit(WORKLOADS["standard"][0], max_new_tokens=3)
        eng2.run()
        assert warm.output[:3] == want[1][:3]
        assert eng2.counters["prefill_tokens"] <= prefill_after + ENGINE_KW["prefill_chunk"]


def test_snapshot_sidecar_matches_jax_format(tmp_path):
    """The sidecar carries the JAX sidecar's host state under the same keys
    (the generator's state where JAX keeps a key; the stripe counters
    beside the free list), equal for the same run."""
    got = {}
    for pkg in PKGS:
        eng = _mid_flight_engine(pkg, tmp_path / pkg)
        eng.snapshot()
        blob = eng._ckpt.manifest(eng._tick)["extra"]["serving"]
        for r in blob["slots"] + blob["queue"]:
            if r is not None:
                r["t_submit"] = r["t_first"] = r["t_done"] = None
        blob.pop("generator" if pkg == "torch" else "key")
        for name in ("in_stripe", "stripes_at_high_water"):
            blob["allocator"].pop(name, None)
        got[pkg] = blob
        assert eng._ckpt.manifest(eng._tick)["keys"] == ["block_tables", "k", "len", "pos",
                                                           "v"]
    assert got["torch"] == got["jax"]


def test_periodic_snapshots_during_run(tmp_path):
    _, _, tb, tparams = _ctx()
    eng = _engine("torch", snapshot_dir=str(tmp_path), snapshot_every=3, **ENGINE_KW)
    for p in WORKLOADS["standard"]:
        eng.submit(p, max_new_tokens=4)
    eng.run()
    assert eng.counters["snapshots"] >= 1 and eng._ckpt.latest_step() is not None
    eng2 = TEngine.from_snapshot(tb, tparams, str(tmp_path), device="cpu")
    eng2.auditor.check()
    eng2.run()
    assert eng2.auditor.violations() == []


def test_snapshot_knob_validation():
    with pytest.raises(ValueError, match="snapshot_dir"):
        _engine("torch", max_batch=2, max_len=32, snapshot_every=5)
    with pytest.raises(ValueError, match="max_retries"):
        _engine("torch", max_batch=2, max_len=32, max_retries=-1)
    eng = _engine("torch", max_batch=2, max_len=32)
    with pytest.raises(RuntimeError, match="snapshot_dir"):
        eng.snapshot()
    with pytest.raises(RuntimeError, match="snapshot_dir"):
        eng.restore_snapshot()


def test_straggler_monitor_surfaced_in_stats():
    eng = _engine("torch", max_batch=2, max_len=32)
    eng.submit([3, 1, 4], max_new_tokens=3)
    eng.run()
    st = eng.stats()
    assert st["step_time"]["median_s"] > 0.0
    assert st["step_time"]["straggler_events"] == st["straggler_events"]
    assert st["degrade"] == {"level": 0, "mode": "normal", "escalations": 0}
    assert st["audits"] == {"post_recovery": 0, "post_recovery_violations": 0}


# ---------------------------------------------------------------------------
# chaos property, derandomised: fixed seeded plans, port vs JAX on each
# ---------------------------------------------------------------------------


def _chaos_plans(n=8, seed=2024):
    rng = np.random.default_rng(seed)
    plans = []
    for _ in range(n):
        specs = []
        for _ in range(int(rng.integers(1, 4))):
            uid = int(rng.integers(0, 4))
            specs.append((tres.TICK_POINTS[int(rng.integers(len(tres.TICK_POINTS)))],
                          int(rng.integers(0, 6)), int(rng.integers(1, 3)), uid or None))
        plans.append((specs, int(rng.integers(0, 2**16))))
    return plans


@pytest.mark.parametrize("specs,seed", _chaos_plans(), ids=[f"plan{i}" for i in range(8)])
def test_chaos_random_fault_plans(specs, seed):
    want = _oracle("standard")
    eng, reqs, rec = _both("standard", specs, plan_kw=dict(rate=0.02, seed=seed),
                           max_retries=6)
    for uid, r in reqs.items():
        if r.status == "done":
            assert list(r.output) == want[uid]
        else:
            assert r.status == "failed" and r.error is not None
    assert rec["violations"] == []
    assert all(s is None for s in eng.slots) and not eng.queue, "the engine must drain"

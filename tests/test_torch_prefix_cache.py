"""The port's content-addressed prefix cache against the JAX package.

* ``PrefixIndex`` call for call: the port's and the JAX index driven by the
  same seeded sequences of ``lookup``/``acquire``/``register``/``release``/
  ``evict`` give equal hits, COW candidates, refcounts, evictions, ``stats``
  and ``export_state`` (the sha256 chain keys included);
* the three hypothesis properties of ``tests/test_prefix_cache.py`` run
  against the port, derandomised;
* the engine cases of ``tests/test_paged_cache.py`` (warm hit, COW,
  preemption keeping shared pages) on the port's engine, whose tokens,
  counters and block tables equal the JAX engine's on the same workload;
  every freed or evicted page holds ``PAD_POS`` in each position row;
* at SP 2 and 4 on the virtual ring, the prefix-cache engine and a snapshot
  restart against the JAX SP-1 engine's tokens (the single-device dense
  greedy chain is its oracle, ``test_serving.assert_greedy_chain_matches``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from _jax_engine import JEngine
from test_serving import _legacy_step, assert_greedy_chain_matches
from test_torch_serving import _setup

from repro.serving.kv_cache import PrefixIndex as JIndex
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.kernels.ref import PAD_POS
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.kv_cache import PrefixIndex, pages_for

# ---------------------------------------------------------------------------
# the index, call for call against the JAX index
# ---------------------------------------------------------------------------


def _hit(h):
    return (list(h.pages), h.tokens, h.cow_keep)


def _cow_ok(index, hit, tokens):
    """The COW candidate is a resident page whose first ``cow_keep`` tokens
    continue the request past the hit (among equally long runs the port
    takes the first in key order, the JAX index the first in set order)."""
    if hit.cow_page is None:
        return hit.cow_keep == 0
    page_tokens = index._tokens[index._key_of[hit.cow_page]]
    start = len(hit.pages) * index.page_size
    want = [int(t) for t in tokens[start:start + hit.cow_keep]]
    return list(page_tokens[:hit.cow_keep]) == want and (
        len(tokens) <= start + hit.cow_keep
        or page_tokens[hit.cow_keep] != int(tokens[start + hit.cow_keep]))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("page_size", [1, 2, 4])
def test_prefix_index_matches_jax_call_for_call(seed, page_size):
    rng = np.random.default_rng(seed * 10 + page_size)
    mine, ref = PrefixIndex(page_size), JIndex(page_size)
    next_page = 0
    live: list[list[int]] = []  # per request: index-owned pages it maps
    for _ in range(40):
        op = rng.choice(["admit", "admit", "release", "evict"])
        if op == "admit":
            prompt = rng.integers(0, 3, int(rng.integers(1, 20))).tolist()
            a, b = mine.lookup(prompt), ref.lookup(prompt)
            assert _hit(a) == _hit(b)
            assert _cow_ok(mine, a, prompt) and (a.cow_page is None) == (b.cow_page is None)
            mine.acquire(a.pages)
            ref.acquire(b.pages)
            need = pages_for(max(len(prompt), 1), page_size)
            fresh = list(range(next_page, next_page + need - len(a.pages)))
            next_page += len(fresh)
            assert mine.register(prompt, a.pages + fresh) == ref.register(prompt, a.pages + fresh)
            live.append([p for p in a.pages + fresh if p in mine.pages])
        elif op == "release" and any(live):
            i = int(rng.choice([i for i, m in enumerate(live) if m]))
            page = live[i].pop(int(rng.integers(len(live[i]))))
            assert mine.release(page) == ref.release(page) is True
        elif op == "evict":
            n = int(rng.integers(1, 4))
            assert mine.evict(n) == ref.evict(n)
        assert mine.stats() == ref.stats()
        assert {p: mine.refcount(p) for p in mine.pages} == {p: ref.refcount(p)
                                                               for p in ref.pages}
    assert mine.export_state() == ref.export_state()
    back = PrefixIndex.from_state(ref.export_state())
    assert back.export_state() == ref.export_state()
    assert mine.release(10**6) is ref.release(10**6) is False
    with pytest.raises(ValueError, match="not index-owned"):
        mine.acquire([10**6])


def test_prefix_index_chain_keys_are_the_jax_keys():
    tokens = list(range(50, 87))
    for ps in (1, 4, 16):
        assert PrefixIndex(ps)._chain_keys(tokens) == JIndex(ps)._chain_keys(tokens)
    with pytest.raises(ValueError, match="page_size"):
        PrefixIndex(0)


# ---------------------------------------------------------------------------
# the hypothesis properties of test_prefix_cache.py, against the port
# ---------------------------------------------------------------------------

TOKENS = st.lists(st.integers(0, 3), min_size=1, max_size=24)


def _simulate(index, prompts):
    next_page = max(index.pages, default=999) + 1
    mappings = []
    for prompt in prompts:
        hit = index.lookup(prompt)
        index.acquire(hit.pages)
        need = pages_for(max(len(prompt), 1), index.page_size)
        fresh = list(range(next_page, next_page + need - len(hit.pages)))
        next_page += len(fresh)
        index.register(prompt, list(hit.pages) + fresh)
        mappings.append([p for p in hit.pages + fresh if p in index.pages])
    return mappings


@settings(max_examples=60, deadline=None, derandomize=True)
@given(prompts=st.lists(TOKENS, min_size=1, max_size=6), page_size=st.sampled_from([1, 2, 4]),
       release_order=st.randoms(use_true_random=False))
def test_refcount_conservation(prompts, page_size, release_order):
    index = PrefixIndex(page_size)
    live = [list(m) for m in _simulate(index, prompts)]
    assert index.total_refs() == sum(len(m) for m in live)
    flat = [(i, p) for i, m in enumerate(live) for p in m]
    release_order.shuffle(flat)
    for i, page in flat:
        assert index.release(page) is True
        live[i].remove(page)
        assert index.total_refs() == sum(len(m) for m in live)
    resident = set(index.pages)
    assert sorted(index.evict(len(resident))) == sorted(resident)
    assert index.pages == set() and index.total_refs() == 0


@settings(max_examples=60, deadline=None, derandomize=True)
@given(first=TOKENS, second=TOKENS, page_size=st.sampled_from([1, 2, 4]))
def test_register_never_mutates_resident_entries(first, second, page_size):
    index = PrefixIndex(page_size)
    _simulate(index, [first])
    before = {p: index._key_of[p] for p in index.pages}
    tokens_before = dict(index._tokens)
    _simulate(index, [second])
    for page, key in before.items():
        assert index._key_of[page] == key
        assert index._tokens[key] == tokens_before[key]
    assert index.lookup(first).tokens >= (len(first) // page_size) * page_size


@settings(max_examples=60, deadline=None, derandomize=True)
@given(resident=st.lists(st.integers(0, 3), min_size=4, max_size=24),
       shares=st.tuples(st.integers(0, 24), st.integers(0, 24)),
       page_size=st.sampled_from([2, 4]), data=st.data())
def test_hit_length_monotone_in_shared_tokens(resident, shares, page_size, data):
    index = PrefixIndex(page_size)
    _simulate(index, [resident])
    s1, s2 = sorted(min(s, len(resident)) for s in shares)
    suffix_len = len(resident) - min(s1, s2) + 1
    hits = []
    for s in (s1, s2):
        suffix = data.draw(st.lists(st.integers(10, 13), min_size=suffix_len,
                                    max_size=suffix_len))
        hits.append(index.lookup(list(resident[:s]) + suffix).tokens)
    assert hits[0] <= hits[1] and hits[0] <= s1 and hits[1] <= s2


# ---------------------------------------------------------------------------
# the engine, against the JAX engine on the same workload
# ---------------------------------------------------------------------------

PREFIX_KW = dict(max_batch=2, max_len=64, prefill_chunk=8, page_size=8, max_pages=32,
                 prefix_cache=True)


def _engines(**kw):
    jb, jparams, tb, tparams = _setup()
    kw = dict(PREFIX_KW, **kw)
    return (JEngine(jb, jparams, **kw), TEngine(tb, tparams, device="cpu", **kw),
            (jb, jparams))


def _run_both(engines, prompts, max_new, max_steps=10_000):
    """Submit ``prompts`` to both engines, run, and hold the port's tokens,
    counters, block tables and index stats to the JAX engine's."""
    j, t = engines[:2]
    reqs = [(j.submit(p, max_new_tokens=max_new), t.submit(p, max_new_tokens=max_new))
            for p in prompts]
    j.run(max_steps=max_steps)
    t.run(max_steps=max_steps)
    for a, b in reqs:
        assert b.output == a.output and b.status == a.status
    drop = ("straggler_events",)
    assert ({k: v for k, v in t.counters.items() if k not in drop}
            == {k: v for k, v in j.counters.items() if k not in drop})
    np.testing.assert_array_equal(t._bt, j._bt)
    assert t.prefix.stats() == j.prefix.stats()
    assert t.alloc.utilization()["pages_in_use"] == j.alloc.utilization()["pages_in_use"]
    return [b for _, b in reqs]


def _pad_rows_hold(eng):
    """Every page neither mapped by a slot nor owned by the index has
    ``PAD_POS`` in each position row."""
    in_use = set(eng.prefix.pages) | {int(p) for p in eng._bt.ravel() if p != eng.NULL}
    free = sorted(set(range(eng.max_pages)) - in_use)
    assert set(free) == set(eng.alloc.free_set)
    assert bool((eng.state["pos"][free] == PAD_POS).all())


def test_engine_prefix_warm_hit_skips_prefill_and_matches_cold():
    engines = _engines()
    prompt = list(np.random.default_rng(7).integers(1, 90, 25))
    cold = _run_both(engines, [prompt], 6)[0]
    t = engines[1]
    cold_prefill = t.counters["prefill_tokens"]
    assert t.stats()["prefix"]["indexed_pages"] == 3
    warm = _run_both(engines, [prompt], 6)[0]
    assert warm.output == cold.output
    assert t.counters["prefill_tokens"] == cold_prefill
    s = t.stats()["prefix"]
    assert s["hit_tokens"] >= 24 and s["cow_copies"] == 0
    step = _legacy_step(engines[2][0])
    for r in (cold, warm):
        assert_greedy_chain_matches(*engines[2], r, 2, 64, step)
    _pad_rows_hold(t)


def test_engine_prefix_cow_divergence_never_mutates_shared_page():
    engines = _engines()
    base = list(np.random.default_rng(7).integers(1, 90, 25))
    fork = base[:20] + [(x + 1) % 90 + 1 for x in base[20:]]  # split inside page 3
    _run_both(engines, [base], 6)
    t = engines[1]
    shared = sorted(t.prefix.pages)
    k_before, v_before = t.state["k"][:, shared].clone(), t.state["v"][:, shared].clone()
    forked = _run_both(engines, [fork], 6)[0]
    assert t.stats()["prefix"]["cow_copies"] == 1
    assert torch.equal(t.state["k"][:, shared], k_before)
    assert torch.equal(t.state["v"][:, shared], v_before)
    assert_greedy_chain_matches(*engines[2], forked, 2, 64, _legacy_step(engines[2][0]))
    _pad_rows_hold(t)


def test_engine_preemption_keeps_shared_prefix_pages():
    engines = _engines(max_pages=8)
    prompt = list(np.random.default_rng(7).integers(1, 90, 25))
    a, b = _run_both(engines, [prompt, prompt], 20)
    t = engines[1]
    s = t.stats()
    assert s["preemptions"] >= 1 and len(a.output) == len(b.output) == 20
    assert t.prefix.total_refs() == 0 and s["pages"]["pages_in_use"] == len(t.prefix.pages)
    step = _legacy_step(engines[2][0])
    for r in (a, b):
        assert_greedy_chain_matches(*engines[2], r, 2, 64, step)
    _pad_rows_hold(t)


def test_evicted_pages_are_masked_and_block_tables_match_mid_flight():
    """A pool too small for the index and the next prompt evicts index pages
    (reset to PAD_POS); block tables equal the JAX engine's at every tick."""
    engines = _engines(max_pages=6, max_batch=1)
    rng = np.random.default_rng(3)
    j, t = engines[:2]
    for n in (30, 33, 17):
        prompt = list(rng.integers(1, 90, n))
        j.submit(prompt, max_new_tokens=4)
        t.submit(prompt, max_new_tokens=4)
    for _ in range(40):
        j.run(max_steps=1)
        t.run(max_steps=1)
        np.testing.assert_array_equal(t._bt, j._bt)
        _pad_rows_hold(t)
    assert t.prefix.evictions == j.prefix.evictions > 0
    assert [r.output for r in t.done] == [r.output for r in j.done]


def test_admission_never_evicts_the_pages_it_hit():
    """A tight pool where covering an admission's fresh pages would evict
    the index pages its lookup just hit (refcount 0 until acquired, and the
    chain's last page is a leaf, so first in line): the port's engine skips
    them and defers the request until pages free up (the JAX engine evicts
    them and fails to acquire: ``page ... is not index-owned``).  Every
    chain matches the JAX dense oracle and the auditor stays clean."""
    jb, jparams, tb, tparams = _setup()
    rng = np.random.default_rng(0)
    a = list(rng.integers(1, 90, 33))  # 4 full pages indexed
    r = list(rng.integers(1, 90, 49))  # 6 pages of its own: 2 of 12 left
    c = a + list(rng.integers(1, 90, 24))  # hits a's 4 pages, needs 3 more
    eng = TEngine(tb, tparams, max_batch=2, max_len=96, prefill_chunk=8, page_size=8,
                  max_pages=12, prefix_cache=True, device="cpu")
    first = eng.submit(a, max_new_tokens=2)
    eng.run()
    reqs = [first, eng.submit(r, max_new_tokens=30), eng.submit(c, max_new_tokens=2)]
    hit_pages = set(eng.prefix.pages)
    eng.run(max_steps=3)
    assert reqs[2].status == "queued" and hit_pages <= eng.prefix.pages  # deferred, kept
    eng.run()
    assert all(x.status == "done" for x in reqs) and eng.auditor.violations() == []
    assert eng.stats()["prefix"]["hit_tokens"] >= 32
    step = _legacy_step(jb)
    for x in reqs:
        assert_greedy_chain_matches(jb, jparams, x, 2, 96, step)
    _pad_rows_hold(eng)


def test_admission_never_evicts_its_copy_on_write_source():
    """A tight pool where covering an admission's fresh pages would evict
    the page its lookup picked as the copy-on-write source (refcount 0, the
    chain's leaf, so first in line): the port's engine keeps it and defers
    the request, where evicting it would mask its position rows and copy a
    masked page under the request's kept rows.  The request's chain matches
    the JAX dense oracle and every free page holds ``PAD_POS``."""
    jb, jparams, tb, tparams = _setup()
    rng = np.random.default_rng(4)
    a = list(rng.integers(1, 90, 33))  # 4 full pages indexed, the 4th a leaf
    r = list(rng.integers(1, 90, 49))  # 6 pages of its own: 2 of 12 left
    c = a[:27] + [(x + 1) % 90 + 1 for x in a[27:]] + list(rng.integers(1, 90, 12))
    eng = TEngine(tb, tparams, max_batch=2, max_len=96, prefill_chunk=8, page_size=8,
                  max_pages=12, prefix_cache=True, device="cpu")
    first = eng.submit(a, max_new_tokens=2)
    eng.run()
    hit = eng.prefix.lookup(c[:-1])
    assert len(hit.pages) == 3 and hit.cow_keep == 3  # 3 fresh pages wanted, 2 free
    reqs = [first, eng.submit(r, max_new_tokens=2), eng.submit(c, max_new_tokens=4)]
    eng.run(max_steps=3)
    assert reqs[2].status == "queued" and hit.cow_page in eng.prefix.pages  # deferred, kept
    eng.run()
    assert all(x.status == "done" for x in reqs) and eng.auditor.violations() == []
    assert eng.stats()["prefix"]["cow_copies"] == 1
    step = _legacy_step(jb)
    for x in reqs:
        assert_greedy_chain_matches(jb, jparams, x, 2, 96, step)
    _pad_rows_hold(eng)


def test_prefix_cache_requires_paged():
    _, _, tb, tparams = _setup()
    with pytest.raises(ValueError, match="paged"):
        TEngine(tb, tparams, max_batch=2, max_len=32, prefix_cache=True, device="cpu")


# ---------------------------------------------------------------------------
# SP 2 and 4 on the virtual ring
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(11)
SP_BASE = list(_RNG.integers(1, 90, 33))
SP_PROMPTS = [SP_BASE, SP_BASE[:28] + [(x + 1) % 90 + 1 for x in SP_BASE[28:]], SP_BASE]


@pytest.mark.parametrize("P", [2, 4])
def test_sp_prefix_engine_and_snapshot_restart_match_jax_sp1(P, tmp_path):
    """The prefix-cache engine over P virtual ranks (one slot, so the fork
    sees the base's pages and copies one on write, and the repeat hits in
    full) emits the JAX SP-1 engine's tokens; killed mid-flight and
    restarted from its snapshot it emits them again."""
    jb, jparams, tb, tparams = _setup()
    kw = dict(PREFIX_KW, max_batch=1)
    ref = JEngine(jb, jparams, **kw)
    want = [ref.submit(p, max_new_tokens=6) for p in SP_PROMPTS]
    ref.run()
    want = [r.output for r in want]
    step = _legacy_step(jb)
    for r in ref.done:
        assert_greedy_chain_matches(jb, jparams, r, 1, 64, step)
    sp = tbuild(tb.cfg, TPctx(impl="torch", device="cpu", sp_degree=P))
    eng = TEngine(sp, tparams, device="cpu", **kw)
    got = [eng.submit(p, max_new_tokens=6) for p in SP_PROMPTS]
    eng.run()
    assert [r.output for r in got] == want
    s = eng.stats()
    assert s["prefix"] == ref.stats()["prefix"] and s["prefix"]["cow_copies"] == 1
    assert eng.auditor.violations() == []

    eng = TEngine(sp, tparams, device="cpu", snapshot_dir=str(tmp_path), **kw)
    for p in SP_PROMPTS:
        eng.submit(p, max_new_tokens=6)
    eng.run(max_steps=12)  # the base done, the fork mid-flight
    assert eng.slots[0] is not None and eng.prefix.pages
    eng.snapshot()
    del eng
    eng2 = TEngine.from_snapshot(sp, tparams, str(tmp_path), device="cpu")
    eng2.auditor.check()
    done = sorted(eng2.run(), key=lambda r: r.uid)
    assert [r.output for r in done] == want and eng2.auditor.violations() == []


# ---------------------------------------------------------------------------
# the serve CLI's prefix-cache and resilience lines
# ---------------------------------------------------------------------------


def test_serve_cli_prefix_and_resilience_lines_match_jax(tmp_path, capsys, monkeypatch):
    """The same flags through both CLIs (reduced model, paged, a shared
    system prompt, a seeded fault rate, audits and snapshots): the schedule
    lines, the prefix-cache line and the resilience counts are equal (the
    weights differ, but no request stops at EOS, so the schedule, the index
    and the fired faults depend on the prompts and the seeds only).  The
    reference's adaptive-prefill line, which the port's CLI leaves out, is
    silenced on its side."""
    import repro.launch.serve as jserve
    from repro_torch.launch.serve import main as tmain

    monkeypatch.setattr(jserve, "print_adaptive_prefill", lambda *a, **k: None)
    jmain = jserve.main

    args = ["--reduced", "--requests", "6", "--max-new", "6", "--max-len", "64",
            "--page-size", "8", "--max-pages", "24", "--prefill-chunk", "8",
            "--prefix-cache", "--shared-prefix", "20", "--fault-rate", "0.05",
            "--fault-seed", "3", "--audit-every", "4", "--max-retries", "4",
            "--snapshot-every", "5"]

    def lines(out):
        keep = ("steps:", "pages:", "prefix cache:", "resilience:")
        return [ln.split("; step median")[0] for ln in out.splitlines() if ln.startswith(keep)]

    ts = tmain(args + ["--device", "cpu", "--snapshot-dir", str(tmp_path / "port")])
    got = lines(capsys.readouterr().out)
    js = jmain(args + ["--impl", "xla", "--snapshot-dir", str(tmp_path / "jax")])
    want = lines(capsys.readouterr().out)
    assert len(got) == 4 and got == want
    assert ts["prefix"]["hit_tokens"] > 0 and ts["faults"] == js["faults"] > 0

"""The port's ring core against the JAX package, device-free: the schedule
IR (builders, specs, validation, routing), the executor's generation
semantics with an injected shift, the strategy registry and planner, the
cost models, and the bytes the virtual ring is handed.

The executor's values and gradients on the ring are held against the JAX
executor in ``test_torch_ring_exec.py``; the process-group ring in
``test_torch_ring_pg.py``; the LM trained over the ring in
``test_torch_training.py``.
"""

import dataclasses
import types
import zlib

import numpy as np
import pytest
import torch

from repro.analysis import preconditions as jpre
from repro.core import api as japi
from repro.core import ring_attention as jra
from repro.core import schedule as jsched
from repro.core import strategies as jstrat
from repro.core import token_ring as jtr
from repro_torch.analysis import preconditions as tpre
from repro_torch.core import api as tapi
from repro_torch.core import ring_attention as tra
from repro_torch.core import schedule as tsched
from repro_torch.core import strategies as tstrat
from repro_torch.core import token_ring as ttr
from repro_torch.core.collectives import VirtualRing, fold_ranks, ring_perm, unfold_ranks

PORTED = ("tokenring", "tokenring_faithful", "ring", "ring_bidir")
SERVING = ("decode", "prefill")  # serving-side schedules (core/decode.py)
BUILDERS = ["token_ring_bidir_schedule", "token_ring_faithful_schedule", "ring_schedule",
            "ring_bidir_schedule"]
SPECS = ["token_ring_bidir_spec", "token_ring_faithful_spec", "ring_spec", "ring_bidir_spec"]


def _module_of(name, port):
    if name.startswith("token_ring"):
        return ttr if port else jtr
    return tra if port else jra


def _op(o):
    return (type(o).__name__, dataclasses.astuple(o))


def _ir(s):
    step = lambda st: None if st is None else tuple(_op(o) for o in st.ops)  # noqa: E731
    return (tuple(step(x) for x in s.prologue), step(s.body), s.trips,
            tuple(step(x) for x in s.epilogue), s.static)


# ---------------------------------------------------------------------------
# IR parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("builder", BUILDERS)
def test_schedule_builders_match_jax(builder, P):
    got = getattr(_module_of(builder, True), builder)(P)
    want = getattr(_module_of(builder, False), builder)(P)
    assert _ir(got) == _ir(want)
    assert [tuple(_op(o) for o in st.ops) for st in got.all_steps()] == [
        tuple(_op(o) for o in st.ops) for st in want.all_steps()]


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", SPECS)
def test_schedule_specs_match_jax(spec, P):
    got = getattr(_module_of(spec, True), spec)(P)
    want = getattr(_module_of(spec, False), spec)(P)
    assert _ir(got.schedule) == _ir(want.schedule)
    assert {n: dataclasses.astuple(b) for n, b in got.buffers.items()} == {
        n: dataclasses.astuple(b) for n, b in want.buffers.items()}
    for f in ("out", "n_kv_parts", "torus_hops", "axes"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.expected_coverage(P, 0) == want.expected_coverage(P, 0)


@pytest.mark.parametrize("P", [2, 3, 4, 8])
def test_routing_matches_jax(P):
    axes_cases = [None, (("pod", 2), ("inner", P // 2))] if P % 2 == 0 else [None]
    for builder in BUILDERS:
        for step_t, step_j in zip(getattr(_module_of(builder, True), builder)(P).all_steps(),
                                  getattr(_module_of(builder, False), builder)(P).all_steps()):
            for axes in axes_cases:
                got = [(_op(o), s, d) for o, s, d in tsched.step_messages(step_t, P, axes)]
                want = [(_op(o), s, d) for o, s, d in jsched.step_messages(step_j, P, axes)]
                assert got == want
                for (ot, src, _), (oj, _, _) in zip(tsched.step_messages(step_t, P, axes),
                                                    jsched.step_messages(step_j, P, axes)):
                    for torus in (False, True):
                        assert tsched.message_route(ot, src, P, axes, torus_hops=torus) == \
                            jsched.message_route(oj, src, P, axes, torus_hops=torus)
    for s in range(-P - 1, P + 2):
        for torus in (False, True):
            assert tsched.ring_shift_hops(s, P, torus=torus) == \
                jsched.ring_shift_hops(s, P, torus=torus)
        assert ring_perm(P, s) == [(r, (r + s) % P) for r in range(P)]
    assert tsched.axis_extent(None, None, P) == jsched.axis_extent(None, None, P) == P
    with pytest.raises(tsched.ScheduleError, match="not in declared axes"):
        tsched.axis_extent((("pod", P),), "inner", P)


# ---------------------------------------------------------------------------
# validation (tests/test_schedule.py::TestValidation, one for one)
# ---------------------------------------------------------------------------


def _validate_both(build, initial, match):
    """Build the same schedule from each module's IR classes; both must
    raise ScheduleError with the same message."""
    msgs = []
    for mod in (tsched, jsched):
        with pytest.raises(mod.ScheduleError, match=match) as err:
            build(mod).validate(set(initial))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


class TestValidation:
    def test_aliasing_send_and_compute_write(self):
        _validate_both(lambda m: m.Schedule(prologue=(
            m.Step(m.Send(("p",), 1), m.Compute("q", ("kv",), "p")),)), {"q", "kv", "p"},
            "alias")

    def test_aliasing_two_sends(self):
        _validate_both(lambda m: m.Schedule(prologue=(
            m.Step(m.Send(("a",), 1, into=("x",)), m.Send(("b",), -1, into=("x",))),)),
            {"a", "b"}, "alias")

    def test_snapshot_read_while_written_is_legal(self):
        tsched.Schedule(prologue=(
            tsched.Step(tsched.Send(("p",), 1, into=("ph",)), tsched.Compute("q", ("kv",), "p")),
        )).validate({"q", "kv", "p"})

    def test_unknown_read(self):
        _validate_both(lambda m: m.Schedule(prologue=(m.Step(m.Send(("nope",), 1)),)), {"q"},
                       "unknown buffer")

    def test_merge_unknown_src(self):
        _validate_both(lambda m: m.Schedule(prologue=(m.Step(m.Merge("acc", "nope")),)),
                       {"acc"}, "unknown buffer")

    def test_body_cannot_grow_carry(self):
        _validate_both(lambda m: m.Schedule(body=m.Step(m.Send(("q",), 1, into=("fresh",))),
                                            trips=2), {"q"}, "new buffer")

    def test_body_cannot_write_static(self):
        _validate_both(lambda m: m.Schedule(body=m.Step(m.Send(("kv",), 1)), trips=2,
                                            static=frozenset({"kv"})), {"kv"}, "static")

    def test_trips_without_body(self):
        _validate_both(lambda m: m.Schedule(trips=3), set(), "no body")

    def test_send_into_length_mismatch(self):
        _validate_both(lambda m: m.Schedule(prologue=(
            m.Step(m.Send(("a", "b"), 1, into=("x",))),)), {"a", "b"}, "does not match")


# ---------------------------------------------------------------------------
# generation (double-buffer) semantics, with an injected shift
# (tests/test_schedule.py::TestGenerations, one for one)
# ---------------------------------------------------------------------------


def tag_shift(payload, ring, shift):
    """Fake ring shift: adds ``1000 * |shift|`` to every float leaf, marking
    that the wire saw exactly the step-entry generation of the buffer."""
    return tuple(tuple(x + 1000.0 * abs(shift) if x.is_floating_point() else x for x in b)
                 for b in payload)


def _pair(out_val, lse_val, S=2):
    return torch.full((S, 1, 1), float(out_val)), torch.full((S, 1), float(lse_val))


def _kv(val, S=2):
    x = torch.full((1, S, 1, 1), float(val))
    return x, x, torch.zeros((1, S), dtype=torch.int32)


class TestGenerations:
    def _flash(self, out_val):
        def compute(q, qp, k, v, kp):
            return torch.full((q.shape[0], 1, 1), float(out_val)), torch.zeros((q.shape[0], 1))

        return compute

    def test_send_reads_step_entry_generation(self):
        bufs = {"q": (torch.zeros((2, 1)), torch.zeros((2,), dtype=torch.int32)),
                "kv": _kv(0.0), "p": _pair(2.0, 0.0)}
        sched = tsched.Schedule(prologue=(
            tsched.Step(tsched.Send(("p",), 1, into=("ph",)), tsched.Compute("q", ("kv",), "p")),
        ))
        for overlap in (True, False):
            res = tsched.execute_schedule(sched, bufs, ring=None, compute_fn=self._flash(5.0),
                                          overlap=overlap, shift_fn=tag_shift)
            assert torch.all(res["ph"][0] == 1002.0)
            assert torch.all(res["p"][0] == 5.0)

    def test_merge_sees_received_generation(self):
        bufs = {"q": (torch.zeros((2, 1)), torch.zeros((2,), dtype=torch.int32)),
                "kv": _kv(0.0), "acc": _pair(7.0, 0.0)}
        sched = tsched.Schedule(prologue=(
            tsched.Step(tsched.Send(("acc",), 1), tsched.Compute("q", ("kv",), "p"),
                        tsched.Merge("acc", "p")),
        ))
        res = tsched.execute_schedule(sched, bufs, ring=None, compute_fn=self._flash(3.0),
                                      overlap=True, shift_fn=tag_shift)
        out, lse = res["acc"]
        np.testing.assert_allclose(float(out[0, 0, 0]), 1007.0, rtol=1e-6)
        np.testing.assert_allclose(float(lse[0, 0]), 1000.0, rtol=1e-6)

    def test_modes_produce_identical_values(self):
        bufs = {"q": (torch.ones((2, 1)), torch.zeros((2,), dtype=torch.int32)),
                "kv": _kv(1.0), "acc": _pair(0.5, 0.25)}
        sched = tsched.Schedule(prologue=(
            tsched.Step(tsched.Send(("acc",), 1), tsched.Compute("q", ("kv",), "p"),
                        tsched.Merge("acc", "p")),
        ))
        res = {ov: tsched.execute_schedule(sched, bufs, ring=None, compute_fn=self._flash(2.0),
                                           overlap=ov, shift_fn=tag_shift)
               for ov in (True, False)}
        for name in res[True]:
            for a, b in zip(res[True][name], res[False][name]):
                assert torch.equal(a, b)

    def test_two_axis_send_names_its_item(self):
        sched = tsched.Schedule(prologue=(tsched.Step(tsched.Send(("acc",), 1, axis="pod")),))
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            tsched.execute_schedule(sched, {"acc": _pair(0.0, 0.0)}, ring=VirtualRing(2, "cpu"),
                                    compute_fn=self._flash(0.0))


def test_virtual_ring_shift_moves_rank_r_to_r_plus_s():
    P, B = 4, 2
    x = torch.arange(P * B * 3, dtype=torch.float32).reshape(P * B, 3)
    ring = VirtualRing(P, "cpu")
    for s in (-5, -1, 1, 2, 3):
        (got,), = ring.post(((x,),), s).wait()
        for r in range(P):
            d = (r + s) % P
            assert torch.equal(got[d * B:(d + 1) * B], x[r * B:(r + 1) * B])
        assert got.data_ptr() != x.data_ptr()
    g = torch.randn(2, 8, 3, 2)
    assert torch.equal(unfold_ranks(fold_ranks(g, 4), 4), g)
    assert torch.equal(fold_ranks(g, 4)[2:4], g[:, 2:4])  # rank 1: shard 1 of every batch row


# ---------------------------------------------------------------------------
# registry and planner
# ---------------------------------------------------------------------------


def _grid():
    rng = np.random.default_rng(zlib.crc32(b"planner-grid"))
    out = []
    for P in (2, 4, 8):
        for Hq, Hkv in ((8, 8), (16, 8), (32, 4), (8, 1)):
            for D in (64, 128):
                B = int(rng.integers(1, 5))
                S = P * 2 * int(rng.integers(8, 512))
                out.append((B, S, Hq, Hkv, D, P))
    return out


GRID = _grid()


def test_registry_holds_the_ported_strategies():
    assert tstrat.available_strategies() == tuple(sorted(PORTED + SERVING))
    for name in PORTED + SERVING:
        t, j = tstrat.get_strategy(name), jstrat.get_strategy(name)
        for f in dataclasses.fields(tstrat.SPStrategy):
            if f.name not in ("fn", "comm_cost", "schedule_spec"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
    with pytest.raises(ValueError, match="already registered"):
        tstrat.register_strategy("ring", tra.ring_attention_sp, comm_cost=tra.ring_comm_cost)
    with pytest.raises(ValueError, match="unknown capability"):
        tstrat.register_strategy("x", tra.ring_attention_sp, comm_cost=tra.ring_comm_cost,
                                 bogus=True)
    tstrat.register_strategy("test_plugin", tra.ring_attention_sp, comm_cost=tra.ring_comm_cost)
    try:
        assert "test_plugin" in tstrat.available_strategies()
    finally:
        tstrat.unregister_strategy("test_plugin")
    assert "test_plugin" not in tstrat.available_strategies()
    with pytest.raises(ValueError, match="unknown SP strategy 'nope'"):
        tstrat.get_strategy("nope")


@pytest.mark.parametrize("name", sorted(tstrat.UNPORTED))
def test_unported_strategy_names_its_item(name):
    item = "queue 1 item 8"
    with pytest.raises(NotImplementedError, match=item):
        tstrat.get_strategy(name)
    pctx = tapi.ParallelContext(device="cpu", impl="torch", sp_degree=2, strategy=name)
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match=item):
        tapi.sp_attention(q, q, q, None, None, pctx=pctx)


@pytest.mark.parametrize("shape", GRID, ids=[str(s) for s in GRID])
def test_planner_matches_jax(shape):
    B, S, Hq, Hkv, D, P = shape
    for name in PORTED:
        t, j = tstrat.get_strategy(name), jstrat.get_strategy(name)
        for layout in ("zigzag", "contig"):
            assert tstrat.ineligible_reason(t, Hq=Hq, Hkv=Hkv, P=P, layout=layout) == \
                jstrat.ineligible_reason(j, Hq=Hq, Hkv=Hkv, P=P, layout=layout)
        for bpe in (2, 4):
            for travel in ("float32", "bfloat16"):
                for bidir in (True, False):
                    got = tstrat.strategy_cost(t, B, S, Hq, Hkv, D, P, bytes_per_elem=bpe,
                                               bidir_links=bidir, travel_dtype=travel)
                    want = jstrat.strategy_cost(j, B, S, Hq, Hkv, D, P, bytes_per_elem=bpe,
                                                bidir_links=bidir, travel_dtype=travel)
                    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for bpe in (1, 2, 4):
        for bidir in (True, False):
            kw = dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, P=P, bytes_per_elem=bpe, bidir_links=bidir)
            assert tstrat.resolve_strategy("auto", **kw) == jstrat.resolve_strategy(
                "auto", candidates=PORTED, **kw)
    for causal in (True, False):
        assert tstrat.attention_compute_flops(B, S, Hq, D, P, causal=causal) == \
            jstrat.attention_compute_flops(B, S, Hq, D, P, causal=causal)

    # plan(): the reference's flat plan on a stand-in mesh of one SP axis
    mesh = types.SimpleNamespace(shape={"model": P}, axis_names=("model",))
    for name in (*PORTED, "auto"):
        for travel in ("float32", "bfloat16"):
            kw = dict(strategy=name, travel_dtype=travel, bidir_links=True, overlap=True)
            shapes = dict(B=B, Sq=S, Hq=Hq, Hkv=Hkv, D=D, dtype_bytes=2)
            tp = tapi.ParallelContext(device="cpu", sp_degree=P, **kw).plan(
                tapi.AttnShapes(**shapes))
            jctx = japi.ParallelContext(mesh=mesh, data_axis=None, sp_axes=("model",), **kw)
            if name == "auto":  # the reference's pool holds unported strategies
                want_name = jstrat.resolve_strategy(
                    "auto", B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, P=P, layout="zigzag",
                    candidates=PORTED)
                jctx = dataclasses.replace(jctx, strategy=want_name)
            jp = jctx.plan(japi.AttnShapes(**shapes))
            assert tp.strategy == jp.strategy
            assert dataclasses.astuple(tp.cost) == dataclasses.astuple(jp.cost)
            assert tp.compute_flops == jp.compute_flops and tp.pipelines == jp.pipelines
            times = dict(link_bw=1e11, peak_flops=1e15)
            assert tp.modeled_times(**times) == jp.modeled_times(**times)


def test_plan_refuses_what_the_reference_refuses_or_is_not_ported():
    pctx = tapi.ParallelContext(device="cpu", sp_degree=4)
    with pytest.raises(ValueError, match="not divisible by SP degree 4"):
        pctx.plan(tapi.AttnShapes(B=1, Sq=30, Hq=4, Hkv=2, D=16))
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        pctx.plan(tapi.AttnShapes(B=1, Sq=32, Hq=4, Hkv=2, D=16), window=8)
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        pctx.plan(tapi.AttnShapes(B=1, Sq=32, Hq=4, Hkv=2, D=16), topology=object())
    with pytest.raises(ValueError, match="ring has 4 ranks"):
        tapi.ParallelContext(device="cpu", sp_degree=2, ring=VirtualRing(4, "cpu"))
    with pytest.raises(ValueError, match="planning requires"):
        tapi.ParallelContext(device="cpu").plan(tapi.AttnShapes(B=1, Sq=32, Hq=4, Hkv=2, D=16))


@pytest.mark.parametrize("strategy,who", [("tokenring", ("Q block", "token_ring variant='bidir'",
                                                         "variant='faithful'")),
                                          ("ring_bidir", ("KV shard", "ring_bidir",
                                                          "strategy='ring'"))])
def test_odd_local_split_raises_the_reference_message(strategy, who):
    what, name, alt = who
    want = jpre.check_even_split(3, what=what, who=name, alternative=alt)
    assert tpre.check_even_split(3, what=what, who=name, alternative=alt) == want
    pctx = tapi.ParallelContext(device="cpu", impl="torch", sp_degree=2, strategy=strategy)
    q = torch.zeros((1, 6, 2, 16))
    with pytest.raises(ValueError) as err:
        tapi.sp_attention(q, q, q, None, None, pctx=pctx)
    assert str(err.value) == want
    assert tpre.check_zigzag_divisible(30, 4) == jpre.check_zigzag_divisible(30, 4)
    assert tpre.check_zigzag_divisible(32, 4) is None


def test_virtual_ring_without_the_card_raises():
    pctx = tapi.ParallelContext(sp_degree=2)  # device="cuda"
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="runs on cuda"):
        tapi.sp_attention(q, q, q, None, None, pctx=pctx)


# ---------------------------------------------------------------------------
# cost models and the bytes the ring is handed
# ---------------------------------------------------------------------------

COSTS = ["token_ring_comm_cost", "token_ring_faithful_comm_cost", "ring_comm_cost",
         "ring_bidir_comm_cost"]


@pytest.mark.parametrize("cost", COSTS)
def test_cost_models_match_jax(cost):
    t, j = getattr(_module_of(cost, True), cost), getattr(_module_of(cost, False), cost)
    for B, S, Hq, Hkv, D, P in GRID + [(1, 64, 4, 2, 16, 1)]:
        for bpe in (1, 2, 4):
            for travel in ("float32", "bfloat16"):
                kw = dict(bytes_per_elem=bpe, bidir_links=True, travel_dtype=travel)
                assert dataclasses.astuple(t(B, S, Hq, Hkv, D, P, **kw)) == \
                    dataclasses.astuple(j(B, S, Hq, Hkv, D, P, **kw))
    assert tstrat.itemsize("bfloat16") == 2 == tstrat.itemsize(torch.bfloat16)
    assert tstrat.itemsize("float32") == jstrat.itemsize("float32")


BYTE_CASES = [(name, P, dtype, travel)
              for P in (2, 4, 8)
              for name, dtype, travel in (("tokenring", torch.float32, "float32"),
                                          ("tokenring", torch.bfloat16, "bfloat16"),
                                          ("tokenring", torch.bfloat16, "float32"),
                                          ("tokenring_faithful", torch.float32, "float32"),
                                          ("ring", torch.bfloat16, "float32"),
                                          ("ring_bidir", torch.float32, "float32"))]


@pytest.mark.parametrize("case", BYTE_CASES, ids=[f"{c[0]}-P{c[1]}-{str(c[2])[6:]}-{c[3]}"
                                                   for c in BYTE_CASES])
def test_ring_bytes_equal_the_cost_models(case):
    """The bytes the transport is handed in one forward pass, per rank and
    direction, equal the strategy's cost model (positions counted apart:
    one int32 row per position of every query or KV block sent)."""
    name, P, dtype, travel = case
    B, S_loc, Hq, Hkv, D = 2, 8, 4, 2, 16
    S = S_loc * P
    ring = VirtualRing(P, "cpu")
    pctx = tapi.ParallelContext(device="cpu", impl="torch", sp_degree=P, strategy=name,
                                travel_dtype=travel, ring=ring)
    q = torch.randn(B, S, Hq, D).to(dtype)
    k = torch.randn(B, S, Hkv, D).to(dtype)
    with torch.no_grad():
        tapi.sp_attention(q, k, k, None, None, pctx=pctx)
    want = tstrat.strategy_cost(tstrat.get_strategy(name), B, S, Hq, Hkv, D, P,
                                bytes_per_elem=q.element_size(), travel_dtype=travel)
    assert ring.link_bytes == {"fwd": want.fwd_bytes, "bwd": want.bwd_bytes}
    rows = {"tokenring": ((P - 1) * S_loc / 2, (P - 1) * S_loc / 2),
            "tokenring_faithful": ((P - 1) * S_loc, 0),
            "ring": ((P - 1) * S_loc, 0),
            "ring_bidir": ((P - 1) * S_loc / 2, (P - 1) * S_loc / 2)}[name]
    assert ring.position_bytes == {"fwd": rows[0] * B * 4, "bwd": rows[1] * B * 4}

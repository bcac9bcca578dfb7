"""The port's other SP strategies against the JAX package, device-free:
Ulysses, the window halo, the two prefill rings, TokenRing2D and the
multi-pod hybrid.  The schedule IR (builders, specs, coverage, routing on
two axes), the registry's descriptors, the cost models (with their
per-class ``links``), ``core/topology.py`` against the original, and the
planner on stand-in meshes: ``plan`` with one and two SP axes ("auto" over
the reference's whole pool), ``plan(topology=...)`` with its decision,
``choose_prefill_strategy`` and ``plan_prefill("auto")`` across hit rates;
then the two CLIs' lines and choices.

Values and gradients on the rings are in ``test_torch_sp_strategies_exec.py``.
Every comparison here is exact: the same integer and float arithmetic.
"""

import dataclasses
import types

import pytest
from test_torch_ring import GRID, _ir, _op

from repro.core import api as japi
from repro.core import hier2d as jh2
from repro.core import prefill_rings as jpr
from repro.core import schedule as jsched
from repro.core import strategies as jstrat
from repro.core import topology as jtopo
from repro.core import ulysses as jul
from repro.core import window as jwin
from repro_torch.core import api as tapi
from repro_torch.core import hier2d as th2
from repro_torch.core import prefill_rings as tpr
from repro_torch.core import schedule as tsched
from repro_torch.core import strategies as tstrat
from repro_torch.core import topology as ttopo
from repro_torch.core import ulysses as tul
from repro_torch.core import window as twin

PS = [1, 2, 3, 4, 8]
NEW = ("ulysses", "window", "passkv_ring", "passq_ring", "tokenring2d")


def _pods(P):
    """(n_pods, n_inner) factorizations of P."""
    return [(n, P // n) for n in range(1, P + 1) if P % n == 0]


# ---------------------------------------------------------------------------
# IR, specs, routing
# ---------------------------------------------------------------------------


def _builders(P):
    out = [("passkv_ring_schedule", (P,)), ("passq_ring_schedule", (P,)),
           ("window_halo_schedule", (P - 1,))]
    out += [("hier2d_schedule", f) for f in _pods(P)]
    return out


def _mod(name, port):
    if name.startswith(("passkv", "passq")):
        return tpr if port else jpr
    if name.startswith("window"):
        return twin if port else jwin
    return th2 if port else jh2


@pytest.mark.parametrize("P", PS)
def test_schedule_builders_match_jax(P):
    for name, args in _builders(P):
        got, want = getattr(_mod(name, True), name)(*args), getattr(_mod(name, False), name)(*args)
        assert _ir(got) == _ir(want), (name, args)
        got.validate({"q", "kv", "kva", "kvb", "kv0", "acc", "qa", "qb", "aa", "ab"})


def _specs(P):
    out = [("passkv_ring_spec", {}), ("passq_ring_spec", {}), ("hier2d_spec", {})]
    out += [("hier2d_spec", {"n_pods": n}) for n, _ in _pods(P)]
    out += [("window_spec", {"S_loc": s, "window": w}) for s in (8, 1024)
            for w in (None, 1, 8, 9, 48, 2048, 5000)]
    return out


@pytest.mark.parametrize("P", PS)
def test_schedule_specs_match_jax(P):
    for name, kw in _specs(P):
        got, want = getattr(_mod(name, True), name)(P, **kw), getattr(_mod(name, False), name)(
            P, **kw)
        assert _ir(got.schedule) == _ir(want.schedule), (name, kw)
        assert {n: dataclasses.astuple(b) for n, b in got.buffers.items()} == {
            n: dataclasses.astuple(b) for n, b in want.buffers.items()}
        for f in ("out", "n_kv_parts", "torus_hops", "axes"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        for r in range(P):
            assert got.expected_coverage(P, r) == want.expected_coverage(P, r), (name, kw, r)
    with pytest.raises(ValueError, match="does not divide"):
        th2.hier2d_spec(6, n_pods=4)


@pytest.mark.parametrize("P", [4, 6, 8])
def test_two_axis_routing_matches_jax(P):
    for n_pods, n_inner in _pods(P):
        spec_t, spec_j = th2.hier2d_spec(P, n_pods=n_pods), jh2.hier2d_spec(P, n_pods=n_pods)
        for st, sj in zip(spec_t.schedule.all_steps(), spec_j.schedule.all_steps()):
            got = [(_op(o), s, d) for o, s, d in tsched.step_messages(st, P, spec_t.axes)]
            want = [(_op(o), s, d) for o, s, d in jsched.step_messages(sj, P, spec_j.axes)]
            assert got == want
            for (ot, src, _), (oj, _, _) in zip(tsched.step_messages(st, P, spec_t.axes),
                                                jsched.step_messages(sj, P, spec_j.axes)):
                assert tsched.message_route(ot, src, P, spec_t.axes) == \
                    jsched.message_route(oj, src, P, spec_j.axes)
        for tag, _ in spec_t.axes:
            assert tsched.axis_extent(spec_t.axes, tag, P) == \
                jsched.axis_extent(spec_j.axes, tag, P)


# ---------------------------------------------------------------------------
# registry, cost models, topology
# ---------------------------------------------------------------------------


def test_registry_equals_the_reference():
    assert tstrat.available_strategies() == jstrat.available_strategies()
    for name in tstrat.available_strategies():
        t, j = tstrat.get_strategy(name), jstrat.get_strategy(name)
        for f in dataclasses.fields(tstrat.SPStrategy):
            if f.name not in ("fn", "comm_cost", "schedule_spec"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert (t.schedule_spec is None) == (j.schedule_spec is None), name
        for P in (2, 4, 8):
            for Hq, Hkv in ((16, 8), (8, 1), (4, 4)):
                for layout in ("zigzag", "contig"):
                    for window in (None, 48):
                        kw = dict(Hq=Hq, Hkv=Hkv, P=P, layout=layout, window=window)
                        assert tstrat.ineligible_reason(t, **kw) == \
                            jstrat.ineligible_reason(j, **kw), (name, kw)
    assert not hasattr(tstrat, "UNPORTED")
    for mod in (tapi, tstrat):
        assert "not ported" not in (mod.__doc__ or "")


COSTS = [(tul.ulysses_comm_cost, jul.ulysses_comm_cost),
         (twin.window_comm_cost, jwin.window_comm_cost),
         (tpr.passkv_ring_comm_cost, jpr.passkv_ring_comm_cost),
         (tpr.passq_ring_comm_cost, jpr.passq_ring_comm_cost),
         (th2.hier2d_comm_cost, jh2.hier2d_comm_cost)]


@pytest.mark.parametrize("i", range(len(COSTS)),
                         ids=[t.__name__ for t, _ in COSTS])
def test_cost_models_match_jax(i):
    tfn, jfn = COSTS[i]
    for B, S, Hq, Hkv, D, P in GRID + [(1, 64, 4, 2, 16, 1), (2, 96, 4, 2, 16, 3)]:
        for bpe in (2, 4):
            for travel in ("float32", "bfloat16"):
                for extra in ({}, {"S_kv": 4 * S}, {"window": 48}, {"window": 4096},
                              *({"n_pods": n} for n, _ in _pods(P))):
                    kw = dict(bytes_per_elem=bpe, bidir_links=True, travel_dtype=travel,
                              **extra)
                    assert dataclasses.astuple(tfn(B, S, Hq, Hkv, D, P, **kw)) == \
                        dataclasses.astuple(jfn(B, S, Hq, Hkv, D, P, **kw)), (B, S, P, kw)
    assert th2.default_pods(6) == jh2.default_pods(6) == 2
    assert th2.default_pods(5) == jh2.default_pods(5) == 1


def _topologies():
    return [("nvlink_pod", (4,), {}), ("nvlink_pod", (2,), {"bw": 1e9}),
            ("half_duplex_pod", (8,), {}), ("two_pods", (2,), {}),
            ("two_pods", (4,), {"inter_bw": 1e12}), ("two_pods", (3,), {"inter_duplex": "half"})]


def test_topology_matches_the_original():
    for fn, args, kw in _topologies():
        t, j = getattr(ttopo, fn)(*args, **kw), getattr(jtopo, fn)(*args, **kw)
        assert (t.name, t.n_devices, t.pods, dict(t.placements)) == \
            (j.name, j.n_devices, j.pods, dict(j.placements))
        assert [dataclasses.astuple(x) for x in t.links] == [
            dataclasses.astuple(x) for x in j.links]
        assert t.class_bandwidths() == j.class_bandwidths()
        assert t.half_duplex_classes() == j.half_duplex_classes()
        assert t.bottleneck_bw() == j.bottleneck_bw() and t.n_pods == j.n_pods
        for a in range(t.n_devices):
            assert t.neighbors(a) == j.neighbors(a) and t.pod_of(a) == j.pod_of(a)
            for b in range(t.n_devices):
                assert t.route(a, b) == j.route(a, b)
        for name in ("ring", "grid", "nope"):
            assert t.placement(name) == j.placement(name)
    for bad in (lambda m: m.Link(0, 0, 1.0), lambda m: m.Link(0, 1, 1.0, duplex="x"),
                lambda m: m.two_pods(1),
                lambda m: m.Topology("t", 2, (), ((0,),)),
                lambda m: m.Topology("t", 2, (), ((0, 1),), {"p": (0, 0)})):
        msgs = []
        for m in (ttopo, jtopo):
            with pytest.raises(ValueError) as err:
                bad(m)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    assert ttopo.DEFAULT_INTER_BW == jtopo.DEFAULT_INTER_BW
    assert ttopo.DEFAULT_INTRA_BW == jtopo.DEFAULT_INTRA_BW


# ---------------------------------------------------------------------------
# the planner on stand-in meshes
# ---------------------------------------------------------------------------


def _jctx(P, pods=1, **kw):
    if pods == 1:
        mesh = types.SimpleNamespace(shape={"model": P}, axis_names=("model",))
        axes = ("model",)
    else:
        mesh = types.SimpleNamespace(shape={"pod": pods, "model": P // pods},
                                     axis_names=("pod", "model"))
        axes = ("pod", "model")
    return japi.ParallelContext(mesh=mesh, data_axis=None, sp_axes=axes, **kw)


def _tctx(P, pods=1, **kw):
    return tapi.ParallelContext(device="cpu", sp_degree=P, pods=pods, **kw)


def _outcome(make, *args, **kw):
    """A plan's comparable fields, or the error it raises."""
    try:
        p = make(*args, **kw)
    except (ValueError, NotImplementedError) as err:
        return type(err).__name__, str(err)
    times = p.modeled_times(link_bw=1e11, peak_flops=1e15)
    return (p.strategy, p.inner, p.kind, p.cost and dataclasses.astuple(p.cost),
            p.compute_flops, p.pipelines, p.topology_decision, times)


STRATS = ("auto", "tokenring", "tokenring_faithful", "ring", "ring_bidir", "ulysses", "window",
          "tokenring2d", "passq_ring")


@pytest.mark.parametrize("shape", GRID, ids=[str(s) for s in GRID])
def test_plan_matches_jax_on_one_and_two_axes(shape):
    """``plan`` on the reference's whole pool ("auto" unrestricted), with
    one SP axis and with two (the hybrid: the inner pool, the intra-pod
    degree, its errors), windowed layers included."""
    B, S, Hq, Hkv, D, P = shape
    for pods in sorted({1, 2, P}):
        for name in STRATS:
            for inner in (None, "ulysses", "ring_bidir") if pods > 1 else (None,):
                for layout, window in (("zigzag", None), ("contig", None), ("contig", 48),
                                       ("zigzag", 48)):
                    kw = dict(strategy=name, inner_strategy=inner, layout=layout)
                    shapes = dict(B=B, Sq=S, Hq=Hq, Hkv=Hkv, D=D, dtype_bytes=2)
                    got = _outcome(_tctx(P, pods, **kw).plan, tapi.AttnShapes(**shapes),
                                   window=window)
                    want = _outcome(_jctx(P, pods, **kw).plan, japi.AttnShapes(**shapes),
                                    window=window)
                    assert got == want, (pods, kw, window)
    for bpe in (1, 2, 4):
        for bidir in (True, False):
            kw = dict(B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, P=P, bytes_per_elem=bpe, bidir_links=bidir)
            assert tstrat.resolve_strategy("auto", **kw) == jstrat.resolve_strategy("auto", **kw)


TOPO_SHAPES = [(1, 64, 8, 8, 64), (2, 4096, 16, 8, 128), (1, 8192, 32, 4, 128), (1, 512, 8, 1, 64),
               (1, 96, 4, 2, 16)]


@pytest.mark.parametrize("shape", TOPO_SHAPES, ids=[str(s) for s in TOPO_SHAPES])
def test_topology_plans_match_jax(shape):
    B, S, Hq, Hkv, D = shape
    cases = []
    for n in (2, 3, 4):
        cases += [(jtopo.two_pods, ttopo.two_pods, (n,), {"inter_bw": bw}, 2)
                  for bw in (1e9, 12.5e9, 1e12)]
        cases.append((jtopo.two_pods, ttopo.two_pods, (n,), {"inter_duplex": "half"}, 2))
        cases.append((jtopo.two_pods, ttopo.two_pods, (n,), {}, 1))
    for n in (2, 4, 8):
        cases += [(jtopo.nvlink_pod, ttopo.nvlink_pod, (n,), {}, 1),
                  (jtopo.half_duplex_pod, ttopo.half_duplex_pod, (n,), {}, 1),
                  (jtopo.nvlink_pod, ttopo.nvlink_pod, (n,), {}, 2)]
    for jmake, tmake, args, kw, pods in cases:
        P = tmake(*args, **kw).n_devices
        if S % P:
            continue
        for name in ("auto", "tokenring2d", "tokenring", "ring_bidir"):
            for bidir in (True, False):
                for travel in ("float32", "bfloat16"):
                    ckw = dict(strategy=name, bidir_links=bidir, travel_dtype=travel)
                    shapes = dict(B=B, Sq=S, Hq=Hq, Hkv=Hkv, D=D, dtype_bytes=2)
                    got = _outcome(_tctx(P, pods, **ckw).plan, tapi.AttnShapes(**shapes),
                                   topology=tmake(*args, **kw))
                    want = _outcome(_jctx(P, pods, **ckw).plan, japi.AttnShapes(**shapes),
                                    topology=jmake(*args, **kw))
                    if got[0] == "ValueError" and "tokenring2d" in got[1]:
                        # the reference names its mesh's SP axes, the port its pods
                        assert want[0] == "ValueError" and "cannot run on" in want[1]
                        continue
                    assert got == want, (args, kw, pods, ckw)
    with pytest.raises(ValueError, match="has 4 devices"):
        _tctx(8).plan(tapi.AttnShapes(B=1, Sq=64, Hq=4, Hkv=2, D=16),
                      topology=ttopo.nvlink_pod(4))


HIT_RATES = (0.0, 0.25, 0.5, 0.9, 1.0)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_prefill_arbitration_matches_jax(P):
    for Sq, Sk, Hq, Hkv, D, bpe in ((4096, 4096, 16, 8, 128, 2), (1024, 4096, 16, 8, 128, 2),
                                    (256, 65536, 32, 4, 128, 2), (64, 64, 8, 8, 64, 4),
                                    (2048, 2048, 8, 1, 64, 2)):
        shapes = dict(B=1, Sq=Sq, Hq=Hq, Hkv=Hkv, D=D, Sk=Sk, dtype_bytes=bpe)
        for bidir in (True, False):
            tctx, jctx = _tctx(P, bidir_links=bidir), _jctx(P, bidir_links=bidir)
            for rate in HIT_RATES:
                for tp in (None, 128):
                    ts, js = tapi.AttnShapes(**shapes), japi.AttnShapes(**shapes)
                    assert tctx.effective_prefill_shapes(ts, prefix_hit_rate=rate) == \
                        tapi.AttnShapes(**dataclasses.asdict(
                            jctx.effective_prefill_shapes(js, prefix_hit_rate=rate)))
                    want = jctx.choose_prefill_strategy(js, prefix_hit_rate=rate,
                                                        table_pages=tp)
                    assert tctx.choose_prefill_strategy(ts, prefix_hit_rate=rate,
                                                        table_pages=tp) == want
                    for strategy in ("auto", *tapi.PREFILL_CANDIDATES):
                        kw = dict(strategy=strategy, shapes=None, prefix_hit_rate=rate,
                                  table_pages=tp)
                        got = _outcome(tctx.plan_prefill, **{**kw, "shapes": ts})
                        exp = _outcome(jctx.plan_prefill, **{**kw, "shapes": js})
                        assert got == exp, (strategy, rate, tp)
                        assert got[0] == (want if strategy == "auto" else strategy)
    tctx = _tctx(P)
    with pytest.raises(ValueError, match="needs shapes="):
        tctx.plan_prefill(strategy="auto")
    with pytest.raises(ValueError, match="not in"):
        tctx.effective_prefill_shapes(tapi.AttnShapes(B=1, Sq=8, Hq=4, Hkv=2, D=16),
                                      prefix_hit_rate=1.5)
    assert tapi.PREFILL_CANDIDATES == japi.PREFILL_CANDIDATES


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_serve_cli_adaptive_prefill_line_matches_jax(capsys, monkeypatch):
    """The JAX CLI builds its planning mesh as ``AbstractMesh(((name,
    size),))``, the signature of the JAX versions it pins; the installed
    JAX takes sizes and names apart, so the test hands it that mesh."""
    import jax

    from repro.configs import ARCHS as JARCHS
    from repro.launch import serve as jserve
    from repro_torch.configs import ARCHS as TARCHS
    from repro_torch.launch import serve as tserve

    mesh = jax.sharding.AbstractMesh
    monkeypatch.setattr(jax.sharding, "AbstractMesh", lambda spec: mesh(
        tuple(n for _, n in spec), tuple(a for a, _ in spec)))
    for arch in ("qwen3-1.7b", "llama2-7b"):
        for max_len, ps in ((2048, 16), (128, 8), (4096, None)):
            for rate in HIT_RATES + (0.37,):
                tp = -(-max_len // ps) if ps else None
                for t, j in ((tserve, jserve),):
                    t.print_adaptive_prefill(TARCHS[arch], max_len=max_len, table_pages=tp,
                                             prefix_hit_rate=rate)
                    got = capsys.readouterr().out
                    j.print_adaptive_prefill(JARCHS[arch], max_len=max_len, table_pages=tp,
                                             prefix_hit_rate=rate)
                    assert got == capsys.readouterr().out
                kw = dict(max_batch=4, chunk=16, max_len=max_len, page_size=ps,
                          prefix_hit_rate=rate)
                tserve.print_serving_plan(TARCHS[arch], **kw)
                got = capsys.readouterr().out
                jserve.print_serving_plan(JARCHS[arch], **kw)
                assert got == capsys.readouterr().out
                assert "adaptive prefill @ SP=4" in got


def test_train_cli_strategy_choices_match_jax():
    import argparse

    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    def choices(mod):
        seen = {}

        class Stop(Exception):
            pass

        def parse(self, argv=None):
            for a in self._actions:
                seen[a.dest] = a.choices
            raise Stop

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = parse
        try:
            mod.main([])
        except Stop:
            pass
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    t, j = choices(ttrain), choices(jtrain)
    assert list(t["strategy"]) == list(j["strategy"])
    assert "window" not in t["strategy"] and "tokenring2d" not in t["strategy"]
    assert "ulysses" in t["strategy"]
    assert "pods" in t

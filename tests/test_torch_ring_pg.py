"""The ring strategies over a ``torch.distributed`` process group: gloo on
the CPU at P = 4 and P = 8, one spawned process per rank, each on its own
shard (``_ring_pg_worker.run``).  Every variant's output shard and its
q/k/v gradients are held against the JAX executor's run of the same
schedule on the whole sequence (1e-5 in float32, 1e-2 with the bf16
travelling accumulator), ``overlap`` True and False must agree bitwise, and
each rank's bytes of one forward pass equal the cost model.  All variants
run inside one spawn per P, to pay the process start-up once.
"""

import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _ring_pg_worker import TWO_AXIS, VARIANTS, run, run_two_axis
from test_torch_ring_exec import B, BF16_TOL, HKV, HQ, S_LOC, TOL, D, _inputs, _jax_run

from repro_torch.core.strategies import get_strategy, strategy_cost

SPAWN_TIMEOUT_S = 45


@pytest.mark.parametrize("P", [4, 8])
def test_process_group_ring_matches_the_jax_executor(P, tmp_path):
    q, k, v, w, pos = _inputs("pg", P, True)
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, w=w, pos=pos)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, P, str(tmp_path / "init"),
                                           str(tmp_path / "inputs.npz"),
                                           str(tmp_path / f"rank{r}.npz")))
             for r in range(P)]
    for p in procs:
        p.start()
    try:
        want = {}  # the JAX oracle, computed while the ranks run
        for name in VARIANTS:
            jrun = _jax_run(name, P, True)

            def jloss(q, k, v):
                o, _, _ = jrun(q, k, v, pos)
                return jnp.sum(o.astype(jnp.float32) * w), o

            (_, o), g = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
                q, k, v)
            want[name] = [np.asarray(o.astype(jnp.float32))] + [np.asarray(x) for x in g]
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r in range(P):
        got = np.load(tmp_path / f"rank{r}.npz")
        rows = slice(r * S_LOC, (r + 1) * S_LOC)
        for name, (strategy, travel) in VARIANTS.items():
            tol = BF16_TOL if travel == "bfloat16" else TOL
            for i, key in enumerate(("out", "dq", "dk", "dv")):
                a, b = got[f"{name}/True/{key}"], got[f"{name}/False/{key}"]
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {name} {key} overlap")
                np.testing.assert_allclose(a, want[name][i][:, rows],
                                           err_msg=f"rank {r} {name} {key}", **tol)
            cost = strategy_cost(get_strategy(strategy), B, S_LOC * P, HQ, HKV, D, P,
                                 bytes_per_elem=4, travel_dtype=travel)
            assert list(got[f"{name}/bytes"]) == [cost.fwd_bytes, cost.bwd_bytes], (r, name)


def _spawn(target, P, tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, P, str(tmp_path / "init"),
                                              str(tmp_path / "inputs.npz"),
                                              str(tmp_path / f"rank{r}.npz")))
             for r in range(P)]
    for p in procs:
        p.start()
    return procs


def _join(procs):
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def test_process_group_two_axis_strategies_match_jax(tmp_path):
    from test_torch_sp_strategies_exec import Case, _cost, _inputs as case_inputs, _jax_oracle

    P = 4
    cases = {"ulysses": Case("ulysses", P, heads=(8, 4)),
             "tokenring2d": Case("hier2d", P, pods=2),
             "hybrid_tokenring": Case("hybrid", P, pods=2, inner="tokenring"),
             "hybrid_ulysses": Case("hybrid", P, pods=2, inner="ulysses", heads=(8, 4),
                                    layout="contig")}
    assert set(cases) == set(TWO_AXIS)
    data = {}
    for name, case in cases.items():
        x = case_inputs(case)
        x["wl"] = np.zeros_like(x["wl"])  # the public path returns no lse
        cases[name] = (case, x)
        data.update({f"{name}/{n}": a for n, a in x.items()})
    np.savez(tmp_path / "inputs.npz", **data)
    procs = _spawn(run_two_axis, P, tmp_path)
    want = {}
    try:  # the JAX oracle, computed while the ranks run
        for name, (case, x) in cases.items():
            jout, _, jgrads = _jax_oracle(case, x)
            want[name] = [jout, *jgrads]
    finally:
        _join(procs)
    for r in range(P):
        got = np.load(tmp_path / f"rank{r}.npz")
        rows = slice(r * S_LOC, (r + 1) * S_LOC)
        for name, (case, x) in cases.items():
            for i, key in enumerate(("out", "dq", "dk", "dv")):
                a, b = got[f"{name}/True/{key}"], got[f"{name}/False/{key}"]
                np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {name} {key} overlap")
                np.testing.assert_allclose(a, want[name][i][:, rows],
                                           err_msg=f"rank {r} {name} {key}", **TOL)
            cost = _cost(case, x)
            assert list(got[f"{name}/bytes"]) == [cost.fwd_bytes, cost.bwd_bytes], (r, name)
            classes = {k.split("/")[-1] for k in got.files if k.startswith(f"{name}/class/")}
            if case.pods > 1:
                assert classes == {"inter", "intra"}, (r, name)
            for lc in cost.links or ():
                assert list(got[f"{name}/class/{lc.cls}"]) == [lc.fwd_bytes, lc.bwd_bytes]

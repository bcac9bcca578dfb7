"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` on the same numpy inputs, and the transports' counting
of the expert-parallel exchange.

* the dense capacity dispatch at reduced qwen3-moe (8 experts, top-2) and
  reduced llama4 (top-1, a shared expert), with a capacity factor that
  drops tokens (asserted) and one that does not: routing and the ``keep``
  mask equal first, then the output, the aux loss and ``jax.grad`` of every
  leaf; ``_capacity`` over a sweep;
* the expert-parallel paths (all-to-all and replicated-sequence) at P = 2
  and 4 and on a 2 x 2 podded ring with 6 experts (the inner-axis branch),
  drops included, against JAX's own ``_moe_ffn_a2a`` /
  ``_moe_ffn_replicated_seq`` on a ``(1, P)`` mesh of ``("data",
  "model")`` (``(1, 2, 2)`` with a ``"pod"`` axis), computed in a process of
  its own with four host devices (``_moe_jax_oracle.py``): on the virtual
  ring and on a gloo group (``_moe_pg_worker.py``);
* the exchange's bytes against a closed form, and integer all-to-alls
  booked apart from the float link bytes.

Float32 throughout; the limits are ``MODEL_TOL`` of
``test_torch_training.py`` (atol 2e-5, rtol 2e-4): the same float32 ops,
with sums taken in another order.
"""

import multiprocessing as mp
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _moe_jax_oracle import CASES, flat_leaves, inputs, moe_config, params_tree

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ArchConfig as TArchConfig

MODEL_TOL = dict(atol=2e-5, rtol=2e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _tensors(tree, grad=False):
    return {k: _tensors(v, grad) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).requires_grad_(grad)
            for k, v in tree.items()}


def _jax_leaves(tree):
    return dict(flat_leaves(jax.tree.map(np.asarray, tree)))


def _jax_leaves_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the dense capacity dispatch
# ---------------------------------------------------------------------------

DENSE = {"qwen3_moe": "qwen3-moe-30b-a3b", "llama4": "llama4-scout-17b-a16e"}


def _jax_routing(p, x, cfg, C):
    """The JAX dense path's routing and ``keep`` mask, as ``_moe_ffn_dense``
    computes them."""
    B, S, _ = x.shape
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"]["w"])
    _, idx = jax.lax.top_k(logits, cfg.n_experts_per_token)
    flat = idx.reshape(B, -1)
    onehot = jax.nn.one_hot(flat, cfg.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=-1)
    return np.asarray(idx), np.asarray(pos < C)


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("model", sorted(DENSE))
def test_dense_dispatch_matches_jax(model, cf):
    jcfg = JARCHS[DENSE[model]].reduced(capacity_factor=cf)
    tcfg = TARCHS[DENSE[model]].reduced(capacity_factor=cf)
    assert tcfg.n_shared_experts == (model == "llama4")
    B, S = 2, 128
    rng = _rng("dense", model, cf)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jp = jmoe.moe_init(jax.random.PRNGKey(7), jcfg)
    C = tmoe._capacity(tcfg, S)

    # routing and the keep mask first: a flip shows as such
    want_idx, want_keep = _jax_routing(jp, jnp.asarray(x), jcfg, C)
    tp = _tensors(_jax_leaves_tree(jp), grad=True)
    _, idx, _ = tmoe._route(tp["router"]["w"], torch.from_numpy(x), tcfg.n_experts_per_token)
    keep = tmoe._positions(idx.reshape(B, -1), tcfg.n_experts) < C
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert (not want_keep.all()) == (cf == 1.25), "cf 1.25 drops tokens, 4.0 none"

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, jcfg, JPctx(mesh=None))
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tp, tx, tcfg, TPctx(impl="torch", device="cpu"))
    names, leaves = zip(*flat_leaves(tp))
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, [tx, *leaves])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **MODEL_TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **MODEL_TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **MODEL_TOL)
    want = _jax_leaves(jgp)
    assert set(names) == set(want)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[name], err_msg=name, **MODEL_TOL)


def test_capacity_matches_jax():
    for S in (1, 3, 8, 64, 100, 256, 4096):
        for E, K in ((8, 2), (128, 8), (16, 1), (6, 2)):
            for cf in (1.0, 1.25, 2.0, 4.0):
                over = dict(n_experts=E, n_experts_per_token=K, capacity_factor=cf)
                jc = JARCHS["qwen3-moe-30b-a3b"].with_(**over)
                tc = TARCHS["qwen3-moe-30b-a3b"].with_(**over)
                assert tmoe._capacity(tc, S) == jmoe._capacity(jc, S), (S, E, K, cf)


def test_moe_init_layouts():
    """Serving: experts in cfg.dtype, router in param_dtype; training:
    every leaf in param_dtype."""
    cfg = TARCHS["llama4-scout-17b-a16e"].reduced(dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    serve = tmoe.moe_init(gen, cfg, device="cpu")
    train = tmoe.moe_init(gen, cfg, device="cpu", training=True)
    assert {serve[k].dtype for k in ("wg", "wu", "wd")} == {torch.bfloat16}
    assert serve["shared"]["gate"]["w"].dtype == torch.bfloat16
    assert serve["router"]["w"].dtype == torch.float32
    assert {t.dtype for _, t in flat_leaves(train)} == {torch.float32}
    assert serve["wg"].shape == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert serve["wd"].shape == (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)


# ---------------------------------------------------------------------------
# expert parallelism against the JAX package on a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """Every case of ``_moe_jax_oracle.CASES`` run by the JAX package on a
    mesh of four host devices, in a process of its own."""
    out = tmp_path_factory.mktemp("moe_oracle") / "oracle.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "_moe_jax_oracle.py"),
                           str(out)], capture_output=True, text=True, timeout=300, env=env,
                          cwd=REPO)
    assert proc.returncode == 0 and "ORACLE DONE" in proc.stdout, proc.stderr[-4000:]
    return str(out)


def _check(got, want_npz, case, kind, label, grads=True):
    """``got``: dict of y, (aux,) gx and grad/<leaf> against the oracle."""
    pre = f"{case}/{kind}/"
    np.testing.assert_allclose(got["y"], want_npz[pre + "y"], err_msg=f"{label} y", **MODEL_TOL)
    if "aux" in got:
        np.testing.assert_allclose(got["aux"], want_npz[pre + "aux"], err_msg=f"{label} aux",
                                   **MODEL_TOL)
    if not grads:
        return
    np.testing.assert_allclose(got["gx"], want_npz[pre + "gx"], err_msg=f"{label} dx",
                               **MODEL_TOL)
    names = [k[len(pre + "grad/"):] for k in want_npz.files if k.startswith(pre + "grad/")]
    assert names and set(names) == {k[5:] for k in got if k.startswith("grad/")}
    for name in names:
        np.testing.assert_allclose(got["grad/" + name], want_npz[pre + "grad/" + name],
                                   err_msg=f"{label} {name}", **MODEL_TOL)


@pytest.mark.parametrize("kind", ["a2a", "decode"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expert_parallel_virtual_ring_matches_jax(oracle, case, kind):
    P, pods = CASES[case][:2]
    want = np.load(oracle)
    cfg = moe_config(TArchConfig, case)
    pctx = TPctx(impl="torch", device="cpu", sp_degree=P, pods=pods)
    params = _tensors(params_tree(want, f"{case}/param/"), grad=True)
    names, leaves = zip(*flat_leaves(params))
    x, w = inputs(case, kind)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(params, tx, cfg, pctx)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, [tx, *leaves])
    got = {"y": y.detach().numpy(), "aux": aux.detach().numpy(), "gx": grads[0].numpy(),
           **{f"grad/{n}": g.numpy() for n, g in zip(names, grads[1:])}}
    _check(got, want, case, kind, f"virtual ring {case} {kind}")
    if kind == "a2a" and CASES[case][4] < 2:
        # the capacity factor drops entries: no-drop capacities change y
        roomy = moe_config(TArchConfig, case).with_(capacity_factor=8.0)
        with torch.no_grad():
            y_all, _ = tmoe.moe_ffn(params, tx, roomy, pctx)
        assert not torch.allclose(y_all, y.detach(), atol=1e-3), f"{case}: nothing dropped"


@pytest.mark.parametrize("P", [2, 4])
def test_expert_parallel_process_group_matches_jax(oracle, P, tmp_path):
    from _moe_pg_worker import run

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, P, str(tmp_path / "init"), oracle,
                                           str(tmp_path / f"rank{r}.npz")))
             for r in range(P)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    want = np.load(oracle)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(P)]
    cases = [c for c in CASES if CASES[c][0] == P]
    assert cases
    for case in cases:
        for kind in ("a2a", "decode"):
            pre = f"{case}/{kind}/"
            grads = {k[len(pre):]: sum(r[k] for r in ranks)
                     for k in ranks[0].files if k.startswith(pre + "grad/")}
            if kind == "a2a":  # every rank's shard, the aux on every rank alike
                y = np.concatenate([r[pre + "y"] for r in ranks], axis=1)
                gx = np.concatenate([r[pre + "gx"] for r in ranks], axis=1)
                for r in ranks[1:]:
                    assert r[pre + "aux"] == ranks[0][pre + "aux"]
                got = {"y": y, "aux": ranks[0][pre + "aux"], "gx": gx, **grads}
            else:  # the replicated result, every rank's share of dx summed
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r[pre + "y"], ranks[0][pre + "y"])
                got = {"y": ranks[0][pre + "y"], "gx": sum(r[pre + "gx"] for r in ranks),
                       **grads}
            _check(got, want, case, kind, f"gloo P={P} {case} {kind}")
        for r in ranks:  # a serving chunk: replicated in, replicated out
            _check({"y": r[f"{case}/a2a_replicated/y"]}, want, case, "a2a",
                   f"gloo P={P} {case} replicated chunk", grads=False)


def test_expert_parallel_refuses_what_does_not_shard():
    cfg = moe_config(TArchConfig, "p4").with_(n_experts=6)
    x = torch.zeros((1, 8, cfg.d_model))
    params = tmoe.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="not shardable"):
        tmoe.moe_ffn(params, x, cfg, TPctx(impl="torch", device="cpu", sp_degree=4))


# ---------------------------------------------------------------------------
# the transports' bytes
# ---------------------------------------------------------------------------


def test_integer_all_to_all_leaves_the_float_ledger_alone():
    from repro_torch.core.collectives import VirtualRing

    ring = VirtualRing(4, "cpu")
    ids = torch.arange(4 * 4 * 8, dtype=torch.int32).reshape(4, 4, 8)
    got = ring.all_to_all(ids, 1, 1)
    assert ring.link_bytes == {"fwd": 0.0, "bwd": 0.0} and not ring.class_bytes
    assert ring.position_bytes == {"fwd": 4 * 8 * 4 / 2, "bwd": 4 * 8 * 4 / 2}
    # rank j's row q is rank q's chunk j
    for j in range(4):
        for q in range(4):
            assert torch.equal(got[j, q], ids[q, j])
    x = torch.ones((4, 4, 8))
    ring.all_to_all(x, 1, 1)
    assert ring.link_bytes == {"fwd": 4 * 8 * 4 / 2, "bwd": 4 * 8 * 4 / 2}


def test_ulysses_bytes_unmoved():
    """Ulysses' all-to-alls of q/k/v/out at its cost model, its lse apart,
    its positions (all-gathered int32) in position_bytes."""
    from repro_torch.core.ulysses import ulysses_comm_cost, ulysses_sp

    P, B, S, H, D = 4, 1, 32, 4, 8
    pctx = TPctx(impl="torch", device="cpu", sp_degree=P, strategy="ulysses")
    ring = pctx.ring
    q, k, v = (torch.randn(P * B, S // P, H, D) for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32).reshape(P, 1, S // P).reshape(P * B, S // P)
    ring.reset_counts()
    ulysses_sp(q, k, v, pos, pos, ring=ring, causal=True, impl="torch", return_lse=True)
    cost = ulysses_comm_cost(B, S, H, H, D, P, bytes_per_elem=4)
    assert ring.link_bytes == {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}
    assert ring.lse_bytes["fwd"] == B * (S // P) * H * 4 / 2
    assert ring.position_bytes["fwd"] == 2 * (P - 1) * B * (S // P) * 4 / 2


@pytest.mark.parametrize("P", [2, 4])
def test_expert_parallel_bytes_match_the_closed_form(P):
    """One forward of the all-to-all path: per rank and direction the token
    buffer out and the results back, ``2 * P*C_sd*d*b / 2`` float bytes,
    plus the router statistics' two all-reduces of E float32 at
    ``(P-1)/P`` each; the int32 expert-id table, ``P*C_sd*4 / 2`` bytes,
    in position_bytes."""
    cfg = moe_config(TArchConfig, "p4").with_(dtype="float32")
    pctx = TPctx(impl="torch", device="cpu", sp_degree=P)
    params = tmoe.moe_init(torch.Generator().manual_seed(1), cfg, device="cpu")
    B, S, d, E, K = 2, 32, cfg.d_model, cfg.n_experts, cfg.n_experts_per_token
    x = torch.randn((B, S, d), generator=torch.Generator().manual_seed(2))
    T = B * (S // P) * K
    C_sd = tmoe._round8(int(T / P * cfg.capacity_factor))
    pctx.ring.reset_counts()
    with torch.no_grad():
        tmoe.moe_ffn(params, x, cfg, pctx)
    floats = 2 * P * C_sd * d * 4 / 2 + 2 * (P - 1) / P * E * 4
    ints = P * C_sd * 4 / 2
    for way in ("fwd", "bwd"):
        assert pctx.ring.link_bytes[way] == pytest.approx(floats, rel=1e-12)
        assert pctx.ring.position_bytes[way] == ints
        assert pctx.ring.lse_bytes[way] == 0

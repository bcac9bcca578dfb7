"""The other SP strategies on the virtual ring, held against the JAX
functions themselves.

The JAX side runs each strategy function (``ulysses_sp``,
``window_attention_sp``, ``passkv_ring_sp``, ``passq_ring_sp``,
``hier2d_sp``, ``hybrid_sp``) under ``jax.vmap(fn, axis_name="sp")`` over a
rank dimension on one CPU device — nested, ``"pod"`` outside and
``"model"`` inside, for the two-axis ones — with the reference's own flash
(``impl="xla"``), jitted.  The port runs its copy on a ``VirtualRing`` (the
two-axis ones on its ``split`` views) with the plain flash.  Compared: the
output, the lse, and the q/k/v gradients of ``sum(out*w) + sum(lse*wl)``
(rows with an lse), in both overlap modes (bitwise equal), then the bytes
one forward pass hands the ring against the cost model (per link class for
TokenRing2D, ``_hybrid_cost`` for the hybrid; positions and the lse apart).
Zigzag and contiguous layouts, GQA, causal and not.  Tolerance: 1e-5 in
float32; 1e-2 where pass-Q's accumulator travels in bf16 (one bf16 rounding
a merge, as on the JAX side).
"""

import dataclasses
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hier2d as jh2
from repro.core import hybrid as jhy
from repro.core import prefill_rings as jpr
from repro.core import ulysses as jul
from repro.core import window as jwin
from repro.core.zigzag import zigzag_positions
from repro_torch.core import api as tapi
from repro_torch.core import hier2d as th2
from repro_torch.core import hybrid as thy
from repro_torch.core import prefill_rings as tpr
from repro_torch.core import ulysses as tul
from repro_torch.core import window as twin
from repro_torch.core.collectives import VirtualRing, fold_ranks, unfold_ranks
from repro_torch.core.strategies import get_strategy, strategy_cost

B, S_LOC, D = 2, 8, 16
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


@dataclasses.dataclass(frozen=True)
class Case:
    kind: str  # ulysses | window | passkv | passq | hier2d | hybrid
    P: int
    heads: tuple = (4, 2)
    causal: bool = True
    layout: str = "zigzag"
    pods: int = 1
    inner: str | None = None  # the hybrid's
    window: int | None = None
    travel: str = "float32"
    warm: bool = False  # prefill rings: a query suffix against the whole context

    @property
    def id(self):
        bits = [self.kind, f"P{self.P}", f"{self.heads[0]}-{self.heads[1]}", self.layout,
                "causal" if self.causal else "full"]
        if self.pods > 1:
            bits.append(f"{self.pods}x{self.P // self.pods}")
        for extra in (self.inner, self.window and f"w{self.window}",
                      self.travel != "float32" and "travel-bf16", self.warm and "warm"):
            if extra:
                bits.append(str(extra))
        return "-".join(bits)


CASES = [
    Case("ulysses", 2), Case("ulysses", 2, causal=False), Case("ulysses", 4, heads=(8, 4)),
    Case("ulysses", 4, heads=(8, 4), layout="contig"),
    Case("window", 4, layout="contig", window=12), Case("window", 8, layout="contig", window=5),
    Case("window", 4, layout="contig", window=40, causal=False),
    Case("passkv", 4), Case("passkv", 4, causal=False, layout="contig"),
    Case("passkv", 4, layout="contig", warm=True),
    Case("passq", 4), Case("passq", 4, travel="bfloat16"),
    Case("passq", 4, layout="contig", warm=True),
    Case("hier2d", 4, pods=2), Case("hier2d", 8, pods=2, causal=False),
    Case("hier2d", 8, pods=4, heads=(4, 1)),
    Case("hybrid", 4, pods=2, inner="tokenring"), Case("hybrid", 4, pods=2, inner="ring"),
    Case("hybrid", 4, pods=2, inner="ulysses", causal=False),
    Case("hybrid", 8, pods=2, inner="tokenring", travel="bfloat16"),
    Case("hybrid", 8, pods=2, inner="ulysses", heads=(8, 4), layout="contig"),
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _positions(case, S):
    if case.layout == "zigzag":
        return np.concatenate([np.asarray(zigzag_positions(S, case.P, j))
                               for j in range(case.P)]).astype(np.int32)
    return np.arange(S, dtype=np.int32)


def _inputs(case):
    rng = np.random.default_rng(zlib.crc32(case.id.encode()))
    Hq, Hkv = case.heads
    Sk = S_LOC * case.P
    Sq = Sk // 4 if case.warm else Sk  # warm: the last quarter of the context
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    kpos = _positions(case, Sk)
    qpos = kpos[Sk - Sq:] if case.warm else kpos
    return dict(q=f(B, Sq, Hq, D), k=f(B, Sk, Hkv, D), v=f(B, Sk, Hkv, D), w=f(B, Sq, Hq, D),
                wl=f(B, Sq, Hq), qpos=np.broadcast_to(qpos, (B, Sq)).copy(),
                kpos=np.broadcast_to(kpos, (B, Sk)).copy())


def _extra(case):
    if case.kind == "window":
        return {"window": case.window}
    if case.kind in ("passq", "hier2d") or (case.kind == "hybrid" and case.inner == "tokenring"):
        return {"travel_dtype": case.travel}
    return {}


# ---------------------------------------------------------------------------
# the JAX functions under vmap
# ---------------------------------------------------------------------------

JFN = {"ulysses": jul.ulysses_sp, "window": jwin.window_attention_sp,
       "passkv": jpr.passkv_ring_sp, "passq": jpr.passq_ring_sp, "hier2d": jh2.hier2d_sp,
       "hybrid": jhy.hybrid_sp}


def _jax_oracle(case, x):
    """``(out, lse, (dq, dk, dv))`` of the JAX function on global inputs."""
    P, pods = case.P, case.pods
    kw = dict(causal=case.causal, impl="xla", return_lse=True, **_extra(case))
    if case.kind == "hier2d":
        kw["axis_name"] = ("pod", "model")
    elif case.kind == "hybrid":
        kw.update(pod_axis="pod", axis_name="model", inner=case.inner)
    else:
        kw["axis_name"] = "sp"
    fn = partial(JFN[case.kind], **kw)
    if pods > 1:
        fn = jax.vmap(jax.vmap(fn, axis_name="model"), axis_name="pod")
    else:
        fn = jax.vmap(fn, axis_name="sp")

    def ranked(a):  # (B, P*s, ...) -> (P, B, s, ...) [-> (pods, P/pods, B, s, ...)]
        a = a.reshape(B, P, a.shape[1] // P, *a.shape[2:]).swapaxes(0, 1)
        return a.reshape(pods, P // pods, *a.shape[1:]) if pods > 1 else a

    def unranked(a):
        a = a.reshape(P, *a.shape[2 if pods > 1 else 1:])
        return a.swapaxes(0, 1).reshape(B, P * a.shape[2], *a.shape[3:])

    def loss(q, k, v):
        out, lse = fn(ranked(q), ranked(k), ranked(v), ranked(jnp.asarray(x["qpos"])),
                      ranked(jnp.asarray(x["kpos"])))
        out, lse = unranked(out), unranked(lse)
        live = jnp.where(jnp.isneginf(lse), 0.0, lse)
        return jnp.sum(out.astype(jnp.float32) * x["w"]) + jnp.sum(live * x["wl"]), (out, lse)

    (_, (out, lse)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x[n]) for n in "qkv"))
    return np.asarray(out, np.float32), np.asarray(lse), [np.asarray(g) for g in grads]


# ---------------------------------------------------------------------------
# the port on the virtual ring
# ---------------------------------------------------------------------------

TFN = {"ulysses": tul.ulysses_sp, "window": twin.window_attention_sp,
       "passkv": tpr.passkv_ring_sp, "passq": tpr.passq_ring_sp, "hier2d": th2.hier2d_sp,
       "hybrid": thy.hybrid_sp}


def _port(case, x, ring, *, overlap=True, grad=True):
    P = case.P
    kw = dict(causal=case.causal, impl="torch", overlap=overlap, return_lse=True,
              **_extra(case))
    if case.kind == "hier2d":
        kw["ring"] = ring.split(case.pods)
    elif case.kind == "hybrid":
        kw["pod_ring"], kw["ring"] = ring.split(case.pods)
        kw["inner"] = case.inner
    else:
        kw["ring"] = ring
    xs = [torch.from_numpy(x[n]).requires_grad_(grad) for n in "qkv"]
    out, lse = TFN[case.kind](*(fold_ranks(t, P) for t in xs),
                              fold_ranks(torch.from_numpy(x["qpos"]), P),
                              fold_ranks(torch.from_numpy(x["kpos"]), P), **kw)
    out, lse = unfold_ranks(out, P), unfold_ranks(lse, P)
    if not grad:
        return out, lse, None
    live = torch.where(torch.isneginf(lse), 0.0, lse)
    loss = (out.float() * torch.from_numpy(x["w"])).sum() + (live * torch.from_numpy(x["wl"])).sum()
    return out.detach(), lse.detach(), torch.autograd.grad(loss, xs)


def _cost(case, x):
    """The cost model of one forward pass, per rank."""
    Hq, Hkv = case.heads
    Sq, Sk = x["q"].shape[1], x["k"].shape[1]
    if case.kind == "hybrid":
        pctx = tapi.ParallelContext(device="cpu", sp_degree=case.P, pods=case.pods,
                                    strategy=case.inner, travel_dtype=case.travel,
                                    layout=case.layout)
        return pctx.plan(tapi.AttnShapes(B=B, Sq=Sq, Hq=Hq, Hkv=Hkv, D=D, dtype_bytes=4)).cost
    name = {"passkv": "passkv_ring", "passq": "passq_ring", "hier2d": "tokenring2d"}.get(
        case.kind, case.kind)
    extra = dict(_extra(case), n_pods=case.pods)
    return strategy_cost(get_strategy(name), B, Sq, Hq, Hkv, D, case.P, bytes_per_elem=4,
                         S_kv=Sk, **extra)


def _positions_sent(case, x):
    """int32 position bytes per rank and direction one forward pass hands
    the ring (the cost models leave them out)."""
    P, rows = case.P, B * S_LOC * 4  # one rank's KV position rows
    q_rows = x["q"].shape[1] // P * B * 4
    if case.kind == "ulysses":  # two all-gathers
        return (P - 1) * (q_rows + rows) / 2, (P - 1) * (q_rows + rows) / 2
    if case.kind == "window":
        halo = min(P - 1, -(-(case.window - 1) // S_LOC))
        return halo * rows, 0.0
    if case.kind == "passkv":
        return (P - 1) * rows / 2, (P - 1) * rows / 2
    if case.kind == "passq":
        return (P - 1) * q_rows, 0.0
    return None  # checked through the link bytes only


# One-axis cases here; TokenRing2D and the hybrid in
# test_torch_sp_strategies_exec_2d.py (two files, so that two workers share them)
ONE_AXIS = [c for c in CASES if c.pods == 1]


@pytest.mark.parametrize("case", ONE_AXIS, ids=[c.id for c in ONE_AXIS])
def test_strategy_matches_the_jax_function(case):
    check_case(case)


def check_case(case):
    """One case, as the module docstring says."""
    x = _inputs(case)
    jout, jlse, jgrads = _jax_oracle(case, x)
    tol = BF16_TOL if case.travel == "bfloat16" else TOL
    runs = {ov: _port(case, x, VirtualRing(case.P, "cpu"), overlap=ov) for ov in (True, False)}
    for a, b in zip((runs[True][0], runs[True][1], *runs[True][2]),
                    (runs[False][0], runs[False][1], *runs[False][2])):
        assert torch.equal(a, b), "overlap=True and overlap=False differ"
    out, lse, grads = runs[True]
    np.testing.assert_allclose(out.float().numpy(), jout, err_msg="out", **tol)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()), np.isneginf(jlse))
    live = ~np.isneginf(jlse)
    np.testing.assert_allclose(lse.numpy()[live], jlse[live], err_msg="lse", **tol)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, err_msg=f"d{name}", **tol)

    # the bytes of one forward pass against the cost model
    ring = VirtualRing(case.P, "cpu")
    with torch.no_grad():
        _port(case, x, ring, grad=False)
    cost = _cost(case, x)
    assert ring.link_bytes == {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}
    if cost.links is not None:
        want = {lc.cls: {"fwd": lc.fwd_bytes, "bwd": lc.bwd_bytes} for lc in cost.links
                if lc.fwd_bytes or lc.bwd_bytes}
        assert ring.class_bytes == want
    if case.kind == "hybrid":
        assert set(ring.class_bytes) <= {"inter", "intra"} and ring.class_bytes["inter"]["fwd"]
    # Ulysses' lse all-to-all: once a pass (once an outer step in the hybrid)
    passes = case.pods if case.kind == "hybrid" and case.inner == "ulysses" else int(
        case.kind == "ulysses")
    lse_half = passes * B * x["q"].shape[1] // case.P * case.heads[0] * 4 / 2
    assert ring.lse_bytes == {"fwd": lse_half, "bwd": lse_half}
    sent = _positions_sent(case, x)
    if sent is not None:
        assert ring.position_bytes == {"fwd": sent[0], "bwd": sent[1]}


def test_refusals_match_the_jax_functions():
    """The same words as the reference where a strategy cannot run."""
    x = _inputs(Case("ulysses", 4))  # 4/2 heads on 4 ranks
    msgs = []
    for run in (lambda: _port(Case("ulysses", 4), x, VirtualRing(4, "cpu"), grad=False),
                lambda: _jax_oracle(Case("ulysses", 4), x)):
        with pytest.raises(ValueError, match="divisible by the SP degree") as err:
            run()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    for inner, match in (("ring_bidir", "cannot run inside"), ("tokenring", "even local")):
        case = Case("hybrid", 4, pods=2, inner=inner)
        y = dict(x, **{n: x[n][:, :12] for n in ("q", "w", "wl", "qpos")}) if inner == \
            "tokenring" else x
        y = dict(y, **{n: y[n][:, :12] for n in ("k", "v", "kpos")}) if inner == \
            "tokenring" else y
        msgs = []
        for run in (lambda: _port(case, y, VirtualRing(4, "cpu"), grad=False),
                    lambda: _jax_oracle(case, y)):
            with pytest.raises(ValueError, match=match) as err:
                run()
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    ring = VirtualRing(4, "cpu")
    pod, inner = ring.split(2)
    with pytest.raises(ValueError, match="unknown inner_kwargs"):
        thy.hybrid_sp(*(torch.zeros(8, 2, 2, 16) for _ in range(3)),
                      *(torch.zeros(8, 2, dtype=torch.int32) for _ in range(2)),
                      pod_ring=pod, ring=inner, inner="ring", travle_dtype="bfloat16")
    with pytest.raises(ValueError, match="do not divide"):
        ring.split(3)
    assert ring.split(2)[0] is pod  # views are made once per factorization

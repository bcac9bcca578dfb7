"""The ring executor on the virtual ring, held against the JAX executor.

The JAX side runs ``repro.core.schedule.execute_schedule`` on one CPU
device with ``P`` virtual ranks folded into the batch dimension (rank ``r``
holds rows ``[r*B, (r+1)*B)``) and a ``shift_fn`` that rolls them, the
reference's own flash (``impl="xla"``) as the block compute.  The port runs
the same schedule on its ``VirtualRing`` (the plain flash).  Every final
buffer is compared, then the public path (``sp_attention``) against the JAX
executor's output, ``attention_reference`` on the whole sequence, and
``jax.grad`` of the JAX executor run; ``overlap`` True and False must agree
bitwise.  Zigzag positions, GQA 4/2, causal (whole blocks fully masked) and
not.  Tolerance: 1e-5 in float32; 1e-2 for the bfloat16 travelling
accumulator (one bf16 rounding per merge, as on the JAX side).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import merge as jmerge
from repro.core import ring_attention as jra
from repro.core import schedule as jsched
from repro.core import token_ring as jtr
from repro.core.zigzag import zigzag_positions
from repro.kernels import ops as jops
from repro.kernels.ref import attention_reference
from repro_torch.core import merge as tmerge
from repro_torch.core import ring_attention as tra
from repro_torch.core import schedule as tsched
from repro_torch.core import token_ring as ttr
from repro_torch.core.api import ParallelContext, sp_attention
from repro_torch.core.collectives import VirtualRing, fold_ranks
from repro_torch.kernels import ops as tops

B, S_LOC, HQ, HKV, D = 2, 8, 4, 2, 16
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)

# variant -> (strategy, travel dtype, schedule builder name)
VARIANTS = {
    "tokenring": ("tokenring", "float32", "token_ring_bidir_schedule"),
    "tokenring_faithful": ("tokenring_faithful", "float32", "token_ring_faithful_schedule"),
    "ring": ("ring", "float32", "ring_schedule"),
    "ring_bidir": ("ring_bidir", "float32", "ring_bidir_schedule"),
    "tokenring_travel_bf16": ("tokenring", "bfloat16", "token_ring_bidir_schedule"),
}


def cases(variants):
    """Every variant at P = 2, 4 and 8, causal and not (the bf16 travel
    variant causal only)."""
    return [(v, P, causal) for v in variants for P in (2, 4, 8) for causal in (True, False)
            if v != "tokenring_travel_bf16" or causal]


def case_id(case):
    v, P, causal = case
    return f"{v}-P{P}-{'causal' if causal else 'full'}"


# TokenRing here; the baselines and the faithful schedule in
# test_torch_ring_exec_baselines.py (two files, so that two workers share them)
CASES = cases(("tokenring", "tokenring_travel_bf16"))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(variant, P, causal):
    rng = np.random.default_rng(zlib.crc32(repr(("ring_exec", variant, P, causal)).encode()))
    S = S_LOC * P
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, HKV, D)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    pos = np.concatenate([np.asarray(zigzag_positions(S, P, j)) for j in range(P)])
    return q, k, v, w, np.broadcast_to(pos, (B, S)).astype(np.int32).copy()


def _buffers(strategy, q, k, v, pos, travel, empty_partial, dtypes):
    """The strategy module's initial buffers, from folded q/k/v/positions."""
    if strategy == "tokenring":
        h = q.shape[1] // 2
        return {"qa": (q[:, :h], pos[:, :h]), "qb": (q[:, h:], pos[:, h:]), "kv": (k, v, pos),
                "aa": empty_partial(q[:, :h].shape, dtype=dtypes[travel]),
                "ab": empty_partial(q[:, h:].shape, dtype=dtypes[travel])}
    if strategy == "ring_bidir":
        h = k.shape[1] // 2
        return {"q": (q, pos), "kva": (k[:, :h], v[:, :h], pos[:, :h]),
                "kvb": (k[:, h:], v[:, h:], pos[:, h:]), "acc": empty_partial(q.shape)}
    return {"q": (q, pos), "kv": (k, v, pos), "acc": empty_partial(q.shape)}


def _jax_run(variant, P, causal):
    """``(out, lse, final buffers)`` of the JAX executor on global inputs."""
    strategy, travel, builder = VARIANTS[variant]
    sched = getattr(jtr if strategy.startswith("token") else jra, builder)(P)
    dtypes = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

    def fold(x):
        x = jnp.asarray(x)
        return x.reshape(B, P, S_LOC, *x.shape[2:]).swapaxes(0, 1).reshape(
            P * B, S_LOC, *x.shape[2:])

    def shift(payload, axis_name, s):
        return jax.tree.map(lambda x: jnp.roll(x, s * B, axis=0), payload)

    def flash(qq, qp, kk, vv, kp):
        return jops.flash_attention(qq, kk, vv, q_pos=qp, k_pos=kp, causal=causal, impl="xla")

    def run(q, k, v, pos):
        bufs = _buffers(strategy, fold(q), fold(k), fold(v), fold(pos), travel,
                        jmerge.empty_partial, dtypes)
        final = jsched.execute_schedule(sched, bufs, axis_name=None, compute_fn=flash,
                                        shift_fn=shift)
        if strategy == "tokenring":
            o = jnp.concatenate([final["aa"][0], final["ab"][0]], axis=1)
            l = jnp.concatenate([final["aa"][1], final["ab"][1]], axis=1)
        else:
            o, l = final["acc"]
        o, l = jmerge.finalize(o, l)

        def unfold(x):
            return x.reshape(P, B, S_LOC, *x.shape[2:]).swapaxes(0, 1).reshape(
                B, P * S_LOC, *x.shape[2:])

        return unfold(o), unfold(l), final

    return run


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_ring_matches_the_jax_executor(case):
    check_ring_case(case)


def check_ring_case(case):
    """One (variant, P, causal) case, as the module docstring says."""
    variant, P, causal = case
    strategy, travel, builder = VARIANTS[variant]
    q, k, v, w, pos = _inputs(variant, P, causal)
    run = _jax_run(variant, P, causal)

    def jloss(q, k, v):
        o, _, final = run(q, k, v, pos)
        return jnp.sum(o.astype(jnp.float32) * w), (o, final)

    (_, (jout, jfinal)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tol = BF16_TOL if travel == "bfloat16" else TOL

    # the executor, buffer by buffer
    tq, tk, tv, tpos = (torch.from_numpy(x) for x in (q, k, v, pos))
    sched = getattr(ttr if strategy.startswith("token") else tra, builder)(P)
    bufs = _buffers(strategy, *(fold_ranks(x, P) for x in (tq, tk, tv, tpos)), travel,
                    tmerge.empty_partial, {"float32": torch.float32, "bfloat16": torch.bfloat16})

    def flash(qq, qp, kk, vv, kp):
        return tops.flash_attention(qq, kk, vv, q_pos=qp, k_pos=kp, causal=causal, impl="torch")

    final = tsched.execute_schedule(sched, bufs, ring=VirtualRing(P, "cpu"), compute_fn=flash)
    assert set(final) == set(jfinal)
    for name in final:
        for i, (a, b) in enumerate(zip(final[name], jfinal[name])):
            a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16
                                                 else b)
            np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b), err_msg=name)
            live = ~np.isneginf(b)
            np.testing.assert_allclose(a[live], b[live], err_msg=f"{name}[{i}]", **tol)

    # the public path: forward, gradients, both overlap modes
    results = {}
    for overlap in (True, False):
        pctx = ParallelContext(device="cpu", impl="torch", sp_degree=P, strategy=strategy,
                               travel_dtype=travel, overlap=overlap)
        xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = sp_attention(*xs, tpos, tpos, pctx=pctx, causal=causal)
        grads = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), xs)
        results[overlap] = (out.detach(), grads)
    out, grads = results[True]
    for a, b in zip((out, *grads), (results[False][0], *results[False][1])):
        assert torch.equal(a, b), "overlap=True and overlap=False differ"
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), **tol)
    ref, _ = attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                 q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos), return_lse=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), **tol)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), err_msg=f"d{name}", **tol)

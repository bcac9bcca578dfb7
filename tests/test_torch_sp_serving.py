"""Sequence-parallel serving in the port against the JAX package.

The JAX serving functions run on one CPU device under
``jax.vmap(..., axis_name="sp")`` over a leading rank dimension: their
``lax.psum`` / ``pmax`` / ``axis_index`` see the P ranks, each rank's cache
shard is one slice of the mapped inputs, and every rank's output is held
against the port's (the port's result is replicated).  The port runs on the
virtual ring (global tensors) and on a gloo process group of spawned ranks
(each on its own shard, ``_sp_serving_pg_worker.run``).

Tolerances: float32 outputs and lse within 1e-5 (the two sides differ only in
the order of the rank sums); bf16 at ``test_torch_decode_numerics``' limits
(out 5e-3 + 1e-2·|ref|, lse 1e-3); model logits within 1e-4 of the JAX model
at SP 1 (``test_torch_serving``'s); engine tokens within
``GREEDY_TOL`` (1e-3) of the JAX SP-1 oracle's max logit, and in float32
equal to the port's SP-1 engine's.  Byte counts and cost models are exact.
"""

import dataclasses
import multiprocessing as mp
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _sp_serving_pg_worker import (
    ENGINE_KW,
    ENGINE_REDUCED,
    ENGINE_RUNS,
    engine_outputs,
    prefix_outputs,
    run,
)
from test_serving import _legacy_step, assert_greedy_chain_matches
from test_torch_serving import _drive, _setup

from repro.core import api as japi
from repro.core import decode as jdec
from repro.core import merge as jmerge
from repro.core import strategies as jstrat
from repro.kernels import ref as jref
from repro.serving import kv_cache as jkv
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core import api as tapi
from repro_torch.core import decode as tdec
from repro_torch.core import merge as tmerge
from repro_torch.core import strategies as tstrat
from repro_torch.core.collectives import VirtualRing, fold_ranks, unfold_ranks
from repro_torch.kernels import ref as tref
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import ServingEngine

PAD = 2**30
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = (dict(atol=5e-3, rtol=1e-2), dict(atol=1e-3, rtol=0.0))  # out, lse
B, HQ, HKV, D, SMAX = 3, 4, 2, 32, 64
PS = (2, 4, 8)
SPAWN_TIMEOUT_S = 60


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype if np.asarray(x).dtype.kind == "f" else None)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _vring(P):
    return VirtualRing(P, "cpu")


# ---------------------------------------------------------------------------
# the merge pieces
# ---------------------------------------------------------------------------


def _partials(rng, n, shape, empty=()):
    """``n`` random partials; ``empty`` (index, mask) pairs set lse = -inf
    (and out = 0) where the mask holds."""
    outs = rng.standard_normal((n, *shape)).astype(np.float32)
    lses = (rng.standard_normal((n, *shape[:-1])) * 3.0).astype(np.float32)
    for i, mask in empty:
        lses[i][mask] = -np.inf
        outs[i][mask] = 0.0
    return outs, lses


def test_merge_paper_form_and_merge_many_match_jax():
    rng = _rng("merge")
    shape = (2, 8, 4, 16)
    outs, lses = _partials(rng, 5, shape)
    got = tmerge.merge_partials_paper_form(_t(outs[0]), _t(lses[0]), _t(outs[1]), _t(lses[1]))
    want = jmerge.merge_partials_paper_form(*(_j(x) for x in (outs[0], lses[0], outs[1],
                                                                lses[1])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32)
    # the paper form is the oracle of merge_partials on finite inputs
    safe = tmerge.merge_partials(_t(outs[0]), _t(lses[0]), _t(outs[1]), _t(lses[1]))
    for g, w in zip(safe, got):
        np.testing.assert_allclose(_np(g), _np(w), **F32)
    mask = rng.random(shape[:-1]) < 0.3
    outs, lses = _partials(rng, 5, shape, empty=[(0, mask), (2, mask), (3, mask)])
    got = tmerge.merge_many([(_t(o), _t(l)) for o, l in zip(outs, lses)])
    want = jmerge.merge_many([(_j(o), _j(l)) for o, l in zip(outs, lses)])
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_reference_matches_jax(seed, blocks, causal):
    rng = _rng("blockwise", seed)
    Bb, S, Hq, Hkv, Dd = 2, 32, 4, 2, 8
    q = rng.standard_normal((Bb, S, Hq, Dd)).astype(np.float32)
    k = rng.standard_normal((Bb, S, Hkv, Dd)).astype(np.float32)
    v = rng.standard_normal((Bb, S, Hkv, Dd)).astype(np.float32)
    got = tref.blockwise_reference(_t(q), _t(k), _t(v), block_k=S // blocks, causal=causal)
    want = jref.blockwise_reference(_j(q), _j(k), _j(v), block_k=S // blocks, causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32)
    full = tref.attention_reference(_t(q), _t(k), _t(v), causal=causal)
    for g, w in zip(got, full):
        np.testing.assert_allclose(_np(g), _np(w), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("P", PS)
def test_psum_merge_matches_jax_and_merge_many(P):
    """Empty ranks, a row empty on every rank but one, and a row empty on
    every rank (``(0, -inf)``)."""
    rng = _rng("psum", P)
    shape = (B, 2, HQ, D)
    empty = [(r, rng.random(shape[:-1]) < 0.3) for r in range(P)]
    outs, lses = _partials(rng, P, shape, empty=empty)
    lses[:, 0, 0] = -np.inf  # every rank empty
    outs[:, 0, 0] = 0.0
    lses[1:, 1, 1] = -np.inf  # only rank 0 holds keys
    outs[1:, 1, 1] = 0.0
    ring = _vring(P)
    got_out, got_lse = tdec.psum_merge_partials(_t(outs.reshape(P * B, *shape[1:])),
                                                _t(lses.reshape(P * B, *shape[1:-1])), ring)
    want = jax.vmap(lambda o, l: jdec.psum_merge_partials(o, l, ("sp",)),
                    axis_name="sp")(_j(outs), _j(lses))
    for r in range(P):
        np.testing.assert_allclose(_np(got_out), np.asarray(want[0][r]), **F32)
        np.testing.assert_allclose(_np(got_lse), np.asarray(want[1][r]), **F32)
    mm = tmerge.merge_many([(_t(o), _t(l)) for o, l in zip(outs, lses)])
    np.testing.assert_allclose(_np(got_out), _np(mm[0]), **F32)
    np.testing.assert_allclose(_np(got_lse), _np(mm[1]), **F32)
    assert torch.equal(got_out[0, 0], torch.zeros(HQ, D)) and torch.isneginf(got_lse[0, 0]).all()
    payload = B * 2 * HQ * (D + 2) * 4
    assert ring.link_bytes == {"fwd": (P - 1) / P * payload, "bwd": (P - 1) / P * payload}


def test_all_reduce_is_forward_only_and_in_rank_order():
    ring = _vring(4)
    x = torch.randn(8, 3)
    np.testing.assert_array_equal(ring.all_reduce(x, "sum").numpy(),
                                  (((x[0:2] + x[2:4]) + x[4:6]) + x[6:8]).numpy())
    np.testing.assert_array_equal(ring.all_reduce(x, "max").numpy(),
                                  x.reshape(4, 2, 3).amax(0).numpy())
    with pytest.raises(RuntimeError, match="forward only"):
        ring.all_reduce(x.requires_grad_(True), "sum")
    with pytest.raises(ValueError, match="unknown reduction"):
        ring.all_reduce(x.detach(), "min")


# ---------------------------------------------------------------------------
# the three attention functions against the JAX functions under vmap
# ---------------------------------------------------------------------------


def dense_case(P, seed=0):
    """Dense cache ``(B, SMAX)`` with lengths 40 (keys on the first ranks
    only), 9 (rank 0 alone below P = 8... and a rank with no live key at
    every P) and 0 (no key at all); the decode query at each row's last
    position, a 4-token chunk after it."""
    rng = _rng("dense", P, seed)
    lengths = np.asarray([40, 9, 0])
    k = rng.standard_normal((B, SMAX, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, SMAX, HKV, D)).astype(np.float32)
    k_pos = np.full((B, SMAX), PAD, np.int32)
    for b, L in enumerate(lengths):
        k_pos[b, :L] = np.arange(L)
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    q_pos = np.maximum(lengths - 1, 0)[:, None].astype(np.int32)
    q_pos[2] = 0  # an empty row's query sees no key
    C = 4
    c_pos = (lengths[:, None] + np.arange(C)).astype(np.int32)
    chunk = [rng.standard_normal((B, C, h, D)).astype(np.float32) for h in (HQ, HKV, HKV)]
    return dict(q=q, k=k, v=v, k_pos=k_pos, q_pos=q_pos, cq=chunk[0], ck=chunk[1],
                cv=chunk[2], c_pos=c_pos)


def paged_case(P, seed=0):
    """Page pool of ``4 * P`` pages of 4 slots striped over the ranks: row 0
    spans every stripe (reversed page order), row 1's pages sit on one
    stripe, row 2 holds no page; sentinel table tails."""
    rng = _rng("paged", P, seed)
    ps, n_pages = 4, 4 * P
    n_local = n_pages // P
    W = n_pages // 2
    k_pool = rng.standard_normal((n_pages, ps, HKV, D)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, ps, HKV, D)).astype(np.float32)
    pos_pool = np.full((n_pages, ps), PAD, np.int32)
    bt = np.full((B, W), n_pages, np.int32)
    row0 = [r * n_local for r in range(P)][::-1][:W]
    row1 = [n_pages - n_local + i for i in range(min(2, n_local))]
    lengths = np.asarray([len(row0) * ps - 1, len(row1) * ps - 2, 0])
    for b, pages in enumerate((row0, row1, [])):
        bt[b, :len(pages)] = pages
        for i, pg in enumerate(pages):
            for off in range(ps):
                if i * ps + off < lengths[b]:
                    pos_pool[pg, off] = i * ps + off
    q = rng.standard_normal((B, 1, HQ, D)).astype(np.float32)
    q_pos = np.maximum(lengths - 1, 0)[:, None].astype(np.int32)
    return dict(q=q, k_pool=k_pool, v_pool=v_pool, pos_pool=pos_pool, block_tables=bt,
                q_pos=q_pos, lengths=lengths.astype(np.int32))


def _shards(x, P, axis=1):
    return np.stack(np.split(x, P, axis=axis))


def jax_dense(d, P, window=None, dtype=jnp.float32):
    """Every rank's JAX ``sp_decode_attention`` and ``sp_prefill_chunk_attention``."""
    dec = jax.vmap(
        lambda kc, vc, kp: jdec.sp_decode_attention(
            _j(d["q"], dtype), kc, vc, kp, axis_names=("sp",), q_pos=_j(d["q_pos"]),
            window=window, impl="xla", return_lse=True),
        axis_name="sp")(*(_j(_shards(d[n], P), dtype) for n in ("k", "v")),
                        _j(_shards(d["k_pos"], P)))
    pre = jax.vmap(
        lambda kc, vc, kp: jdec.sp_prefill_chunk_attention(
            _j(d["cq"], dtype), _j(d["ck"], dtype), _j(d["cv"], dtype), _j(d["c_pos"]),
            kc, vc, kp, axis_names=("sp",), q_pos=_j(d["c_pos"]), window=window, impl="xla",
            return_lse=True),
        axis_name="sp")(*(_j(_shards(d[n], P), dtype) for n in ("k", "v")),
                        _j(_shards(d["k_pos"], P)))
    return dec, pre


def jax_paged(d, P, impl="xla", dtype=jnp.float32):
    """Every rank's JAX ``sp_paged_decode_attention`` on its page stripe."""
    return jax.vmap(
        lambda kp, vp, pp: jdec.sp_paged_decode_attention(
            _j(d["q"], dtype), kp, vp, pp, _j(d["block_tables"]), _j(d["q_pos"]),
            axis_names=("sp",), lengths=_j(d["lengths"]), impl=impl, return_lse=True),
        axis_name="sp")(*(_j(_shards(d[n], P, axis=0), dtype)
                          for n in ("k_pool", "v_pool")), _j(_shards(d["pos_pool"], P, axis=0)))


def _check_ranks(got, want, P, tol=(F32, F32)):
    """The port's replicated ``(out, lse)`` against every JAX rank's."""
    for r in range(P):
        np.testing.assert_allclose(_np(got[0]), np.asarray(want[0][r], np.float32),
                                   err_msg=f"rank {r} out", **tol[0])
        lse, wl = _np(got[1]), np.asarray(want[1][r])
        np.testing.assert_array_equal(np.isneginf(lse), np.isneginf(wl))
        live = ~np.isneginf(wl)
        np.testing.assert_allclose(lse[live], wl[live], err_msg=f"rank {r} lse", **tol[1])


def _pctx(P, **kw):
    return tapi.ParallelContext(device="cpu", impl="torch", sp_degree=P, **kw)


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("window", [None, 48])
def test_sp_decode_and_prefill_match_jax(P, window):
    d = dense_case(P)
    want_dec, want_pre = jax_dense(d, P, window=window)
    pctx = _pctx(P)
    ring = pctx.ring
    plan = pctx.plan_decode(window=window)
    ring.reset_counts()
    got = plan(_t(d["q"]), *(fold_ranks(_t(d[n]), P) for n in ("k", "v", "k_pos")),
               _t(d["q_pos"]))
    assert isinstance(got, torch.Tensor)
    dec = tdec.sp_decode_attention(
        _t(d["q"]), *(fold_ranks(_t(d[n]), P) for n in ("k", "v", "k_pos")),
        q_pos=_t(d["q_pos"]), ring=_vring(P), window=window, impl="torch", return_lse=True)
    _check_ranks(dec, want_dec, P)
    np.testing.assert_array_equal(_np(got), _np(dec[0]))
    assert ring.link_bytes == {"fwd": jdec.decode_comm_cost(B, 1, HQ, HKV, D, P).fwd_bytes,
                               "bwd": jdec.decode_comm_cost(B, 1, HQ, HKV, D, P).bwd_bytes}
    # the empty row: (0, -inf) before finalize, exactly 0 after
    assert torch.isneginf(dec[1][2]).all() and torch.equal(dec[0][2], torch.zeros(1, HQ, D))
    # the public entry point on the rank-major cache
    got = tapi.sp_decode(_t(d["q"]), *(fold_ranks(_t(d[n]), P) for n in ("k", "v", "k_pos")),
                         _t(d["q_pos"]), pctx=pctx, window=window)
    np.testing.assert_array_equal(_np(got), _np(dec[0]))

    pre = tdec.sp_prefill_chunk_attention(
        *(_t(d[n]) for n in ("cq", "ck", "cv", "c_pos")),
        *(fold_ranks(_t(d[n]), P) for n in ("k", "v", "k_pos")), q_pos=_t(d["c_pos"]),
        ring=_vring(P), window=window, impl="torch", return_lse=True)
    _check_ranks(pre, want_pre, P)
    ring.reset_counts()
    got = tapi.sp_prefill(*(_t(d[n]) for n in ("cq", "ck", "cv", "c_pos")),
                          *(fold_ranks(_t(d[n]), P) for n in ("k", "v", "k_pos")),
                          _t(d["c_pos"]), pctx=pctx, window=window)
    np.testing.assert_array_equal(_np(got), _np(pre[0]))
    cost = jdec.prefill_comm_cost(B, 4, HQ, HKV, D, P)
    assert ring.link_bytes == {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}


@pytest.mark.parametrize("P", PS)
def test_sp_paged_decode_matches_jax(P):
    d = paged_case(P)
    want = jax_paged(d, P)
    pctx = _pctx(P)
    got = tdec.sp_paged_decode_attention(
        *(_t(d[n]) for n in ("q", "k_pool", "v_pool", "pos_pool", "block_tables", "q_pos")),
        ring=_vring(P), lengths=_t(d["lengths"]), impl="torch", return_lse=True)
    _check_ranks(got, want, P)
    assert torch.isneginf(got[1][2]).all() and torch.equal(got[0][2], torch.zeros(1, HQ, D))
    pctx.ring.reset_counts()
    out = tapi.sp_decode_paged(*(_t(d[n]) for n in ("q", "k_pool", "v_pool", "pos_pool",
                                                   "block_tables", "q_pos", "lengths")),
                               pctx=pctx)
    np.testing.assert_array_equal(_np(out), _np(got[0]))
    cost = jdec.decode_comm_cost(B, 1, HQ, HKV, D, P)
    assert pctx.ring.link_bytes == {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}


def test_sp_paged_decode_matches_the_pallas_kernel_in_interpret_mode():
    P = 4
    d = paged_case(P, seed=1)
    want = jax_paged(d, P, impl="pallas_interpret")
    got = tdec.sp_paged_decode_attention(
        *(_t(d[n]) for n in ("q", "k_pool", "v_pool", "pos_pool", "block_tables", "q_pos")),
        ring=_vring(P), lengths=_t(d["lengths"]), impl="torch", return_lse=True)
    _check_ranks(got, want, P)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_sp_serving_bf16_matches_jax(kind):
    P = 4
    if kind == "dense":
        d = dense_case(P, seed=2)
        want = jax_dense(d, P, dtype=jnp.bfloat16)[1]
        got = tdec.sp_prefill_chunk_attention(
            *(_t(d[n], torch.bfloat16) for n in ("cq", "ck", "cv", "c_pos")),
            *(fold_ranks(_t(d[n], torch.bfloat16), P) for n in ("k", "v", "k_pos")),
            q_pos=_t(d["c_pos"]), ring=_vring(P), impl="torch", return_lse=True)
    else:
        d = paged_case(P, seed=2)
        want = jax_paged(d, P, dtype=jnp.bfloat16)
        got = tdec.sp_paged_decode_attention(
            *(_t(d[n], torch.bfloat16) for n in ("q", "k_pool", "v_pool", "pos_pool",
                                                 "block_tables", "q_pos")),
            ring=_vring(P), lengths=_t(d["lengths"]), impl="torch", return_lse=True)
    assert got[0].dtype == torch.bfloat16
    _check_ranks(got, want, P, tol=BF16)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_stripe_remap_matches_reference(P):
    n_pages = 6 * P
    n_local = n_pages // P
    rng = _rng("remap", P)
    bt = rng.integers(0, n_pages + 1, (5, 9)).astype(np.int32)
    bt[0] = n_pages  # all sentinel
    bt[1, :P] = np.arange(P) * n_local  # one page on every stripe
    folded = tdec.folded_stripe_tables(_t(bt), P, n_pages).numpy().reshape(P, *bt.shape)
    for r in range(P):
        want = jax.vmap(lambda x: jnp.where(
            jnp.logical_and(bt >= x * n_local, bt < x * n_local + n_local),
            bt - x * n_local, n_local))(jnp.arange(P))[r]  # decode.py:165-174
        got = tdec.stripe_remap(_t(bt), r, n_local).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        # the folded (global-id) tables are the same remap shifted by the stripe
        glob = np.where(got < n_local, got + r * n_local, n_pages)
        np.testing.assert_array_equal(folded[r], glob)
    # stripe_view gathers exactly the entries of each rank's pages
    flat = tkv.view_indices(_t(bt), 4)
    folded_view = tkv.stripe_view(flat, n_pages, 4, P, None).reshape(P, *flat.shape)
    for r in range(P):
        own = tkv.stripe_view(flat, n_pages, 4, P, r)
        live = own < n_local * 4
        np.testing.assert_array_equal((folded_view[r] < n_pages * 4).numpy(), live.numpy())
        np.testing.assert_array_equal(folded_view[r][live].numpy(),
                                      (own[live] + r * n_local * 4).numpy())


# ---------------------------------------------------------------------------
# plans, cost models and the registry
# ---------------------------------------------------------------------------


def _jctx(P):
    return japi.ParallelContext(mesh=jax.sharding.AbstractMesh((P,), ("sp",)),
                                sp_axes=("sp",), data_axis=None)


@pytest.mark.parametrize("P", PS)
def test_serving_plans_match_reference(P):
    tctx, jctx = _pctx(P), _jctx(P)
    for Sq, Sk, dtype_bytes in ((1, 2048, 2), (256, 2048, 2), (3, 512, 4)):
        shapes = dict(B=8, Sq=Sq, Hq=16, Hkv=8, D=128, Sk=Sk, dtype_bytes=dtype_bytes)
        ts, js = tapi.AttnShapes(**shapes), japi.AttnShapes(**shapes)
        for tp in (None, 128):
            for name in ("plan_decode", "plan_decode_paged", "plan_prefill"):
                t = getattr(tctx, name)(shapes=ts, table_pages=tp)
                j = getattr(jctx, name)(shapes=js, table_pages=tp)
                assert t.strategy == j.strategy and t.kind == j.kind, name
                assert dataclasses.astuple(t.cost) == dataclasses.astuple(j.cost), (name, tp)
                # the kernel record: the same path and decode tile (impl names differ)
                strip = lambda k: k and {n: v for n, v in k.items() if n != "impl"}  # noqa: E731
                assert strip(t.kernel) == strip(j.kernel), name
    assert tctx.plan_decode().cost is None
    assert tctx.plan_prefill(strategy="prefill").strategy == "prefill"
    # the prefill rings and "auto" over them, as the reference plans them
    shapes = dict(B=1, Sq=64 * P, Hq=4, Hkv=2, D=32, Sk=256 * P)
    for rate in (0.0, 0.5, 0.9):
        t = tctx.plan_prefill(strategy="auto", shapes=tapi.AttnShapes(**shapes),
                              prefix_hit_rate=rate)
        j = jctx.plan_prefill(strategy="auto", shapes=japi.AttnShapes(**shapes),
                              prefix_hit_rate=rate)
        assert (t.strategy, t.kind) == (j.strategy, j.kind), rate
        assert dataclasses.astuple(t.cost) == dataclasses.astuple(j.cost), rate
    for ring_name in ("passkv_ring", "passq_ring"):
        t, j = tctx.plan_prefill(strategy=ring_name), jctx.plan_prefill(strategy=ring_name)
        assert (t.strategy, t.kind, t.cost, t.pipelines) == (j.strategy, j.kind, j.cost,
                                                              j.pipelines) == (
            ring_name, "prefill", None, True)
    with pytest.raises(ValueError, match="not one of"):
        tctx.plan_prefill(strategy="tokenring")
    with pytest.raises(ValueError, match="sp_degree > 1"):
        tapi.ParallelContext(device="cpu").plan_decode()


def test_serving_cost_models_match_reference():
    rng = _rng("serving-costs")
    for _ in range(200):
        Bb, S = int(rng.integers(1, 17)), int(rng.integers(1, 1025))
        Hq = int(rng.choice([8, 16, 32]))
        Hkv, Dd, P = Hq // int(rng.choice([1, 2, 4])), int(rng.choice([64, 128])), \
            int(rng.integers(1, 9))
        tp = [None, 0, int(rng.integers(1, 257))][int(rng.integers(0, 3))]
        kw = dict(bytes_per_elem=int(rng.choice([2, 4])), S_kv=int(rng.integers(1, 4096)),
                  table_pages=tp)
        for tfn, jfn in ((tdec.decode_comm_cost, jdec.decode_comm_cost),
                         (tdec.prefill_comm_cost, jdec.prefill_comm_cost)):
            assert dataclasses.astuple(tfn(Bb, S, Hq, Hkv, Dd, P, **kw)) == \
                dataclasses.astuple(jfn(Bb, S, Hq, Hkv, Dd, P, **kw))


def test_serving_registry_descriptors_match_reference():
    for name in ("decode", "prefill"):
        t, j = tstrat.get_strategy(name), jstrat.get_strategy(name)
        for f in dataclasses.fields(tstrat.SPStrategy):
            if f.name not in ("fn", "comm_cost", "schedule_spec"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert tstrat.ineligible_reason(t, Hq=16, Hkv=8, P=4) == \
            jstrat.ineligible_reason(j, Hq=16, Hkv=8, P=4)
        # "auto" never picks a serving-side schedule
        assert tstrat.resolve_strategy("auto", S=4096, Hq=16, Hkv=8, D=128, P=4) not in (
            "decode", "prefill")
    assert {"decode", "prefill"} < set(tstrat.available_strategies())


# ---------------------------------------------------------------------------
# cache state and byte accounting
# ---------------------------------------------------------------------------


def test_init_paged_cache_and_cache_bytes_match_reference():
    cfg = TARCHS["qwen3-1.7b"]
    jcfg = __import__("repro.configs", fromlist=["ARCHS"]).ARCHS["qwen3-1.7b"]
    for args in ((8, 2048), (3, 100)):
        assert tkv.dense_cache_bytes(cfg, *args) == jkv.dense_cache_bytes(jcfg, *args)
    for args in ((1024, 16), (7, 4)):
        assert tkv.paged_cache_bytes(cfg, *args) == jkv.paged_cache_bytes(jcfg, *args)
    f32 = cfg.with_(dtype="float32")
    assert tkv.dense_cache_bytes(f32, 2, 8) == jkv.dense_cache_bytes(jcfg.with_(dtype="float32"),
                                                                     2, 8)
    with pytest.raises(ValueError) as got:
        tkv.init_paged_cache(1, 2, 32, n_pages=10, page_size=4, max_batch=2, slot_pages=2,
                             device="cpu", pctx=_pctx(4))
    with pytest.raises(ValueError) as want:
        jkv.init_paged_cache(1, 2, 32, n_pages=10, page_size=4, max_batch=2, slot_pages=2,
                             pctx=_jctx(4))
    assert str(got.value) == str(want.value)
    # the virtual ring holds the whole pool; block tables stay global
    s = tkv.init_paged_cache(1, 2, 32, n_pages=12, page_size=4, max_batch=2, slot_pages=3,
                             device="cpu", pctx=_pctx(4))
    assert s["k"].shape[1] == 12 and int(s["block_tables"].max()) == 12


def test_sp_serving_refuses_a_sharded_cache_without_positions():
    """A shard's slot indices are no global positions: with sp_degree > 1
    the cache's ``k_pos`` must be given."""
    P = 2
    d = dense_case(P)
    pctx = _pctx(P)
    k, v = (fold_ranks(_t(d[n]), P) for n in ("k", "v"))
    with pytest.raises(ValueError, match="k_pos is required"):
        tapi.sp_decode(_t(d["q"]), k, v, None, _t(d["q_pos"]), pctx=pctx)
    with pytest.raises(ValueError, match="k_pos is required"):
        tapi.sp_prefill(*(_t(d[n]) for n in ("cq", "ck", "cv", "c_pos")), k, v, None,
                        _t(d["c_pos"]), pctx=pctx)


def test_serving_plans_are_built_once_per_shape_and_window():
    """The serving steps ask for the same plan in every layer of every step:
    the context builds it once per (shape, window) and hands it back."""
    P = 4
    d = dense_case(P)
    pctx = _pctx(P)
    shapes = tapi.AttnShapes(B=B, Sq=1, Hq=HQ, Hkv=HKV, D=D, Sk=64, dtype_bytes=4)
    plan = pctx.plan_decode(shapes=shapes)
    assert pctx.plan_decode(shapes=shapes) is plan
    assert pctx.plan_decode(shapes=shapes, window=48) is not plan
    assert pctx.plan_decode_paged(shapes=shapes) is not plan
    assert pctx.plan_prefill(shapes=shapes) is pctx.plan_prefill(shapes=shapes)
    pctx = _pctx(P)
    args = (_t(d["q"]), *(fold_ranks(_t(d[n]), P) for n in ("k", "v", "k_pos")),
            _t(d["q_pos"]))
    first = tapi.sp_decode(*args, pctx=pctx)
    (key, plan), = pctx._serving_plans.items()
    assert torch.equal(tapi.sp_decode(*args, pctx=pctx), first)
    assert list(pctx._serving_plans.items()) == [(key, plan)]
    assert plan.cost == tapi.ParallelContext(sp_degree=P, device="cpu").plan_decode(
        shapes=key[3]).cost


def test_sp_serving_refuses_cpu_tensors_on_a_card_context():
    """No fallback: a context on the card (the default) refuses tensors on
    the CPU rather than serving there."""
    d = dense_case(2)
    pctx = tapi.ParallelContext(sp_degree=2)
    with pytest.raises(ValueError, match="runs on cuda"):
        tapi.sp_decode(_t(d["q"]), _t(d["k"]), _t(d["v"]), _t(d["k_pos"]), _t(d["q_pos"]),
                       pctx=pctx)
    with pytest.raises(ValueError, match="runs on cuda"):
        tapi.sp_prefill(*(_t(d[n]) for n in ("cq", "ck", "cv", "c_pos", "k", "v", "k_pos",
                                             "c_pos")), pctx=pctx)
    p = paged_case(2)
    with pytest.raises(ValueError, match="runs on cuda"):
        tapi.sp_decode_paged(*(_t(p[n]) for n in ("q", "k_pool", "v_pool", "pos_pool",
                                                 "block_tables", "q_pos", "lengths")),
                             pctx=pctx)


# ---------------------------------------------------------------------------
# model steps and the engine on the virtual ring
# ---------------------------------------------------------------------------


def _sp_bundle(tb, P):
    return tbuild(tb.cfg, tapi.ParallelContext(impl="torch", device="cpu", sp_degree=P))


@pytest.mark.parametrize("variant", ["mha", "gqa"])
@pytest.mark.parametrize("P", [2, 4])
def test_sp_dense_steps_match_jax_sp1(variant, P):
    """Logits after every chunk and decode step within 1e-4 of the JAX model
    at SP 1, and the rank-major state, unfolded, equal to its cache."""
    jb, jparams, tb, tparams = _setup(variant)
    tb = _sp_bundle(tb, P)
    tstate = tb.init_serve_state(3, 32, "cpu")
    assert tstate["k"].shape[1:3] == (3 * P, 32 // P)

    def view(s):
        layers = {n: torch.stack([unfold_ranks(x, P) for x in s[n]]) for n in ("k", "v")}
        return {**layers, "pos": unfold_ranks(s["pos"], P), "len": s["len"]}

    _drive(jb, jparams, tb, tparams, jb.init_serve_state(3, 32), tstate, paged=False,
           view=view)


@pytest.mark.parametrize("variant", ["mha", "gqa"])
@pytest.mark.parametrize("P", [2, 4])
def test_sp_paged_steps_match_jax_sp1(variant, P):
    """Reversed, non-contiguous pages over every stripe with sentinel
    tails; on the virtual ring the pool is the whole pool."""
    jb, jparams, tb, tparams = _setup(variant)
    tb = _sp_bundle(tb, P)
    n_pages, ps, W = 12, 4, 4
    jstate = jb.init_paged_state(n_pages, ps, 3, W)
    tstate = tb.init_paged_state(n_pages, ps, 3, W, "cpu")
    bt = np.full((3, W), n_pages, np.int32)
    bt[0, :3] = [11, 4, 7]
    bt[1, :2] = [2, 9]
    bt[2, :3] = [0, 5, 10]
    jstate = dict(jstate, block_tables=jnp.asarray(bt))
    tstate["block_tables"].copy_(torch.from_numpy(bt))
    _drive(jb, jparams, tb, tparams, jstate, tstate, paged=True)


def _sp_engine_case(paged, P=4, variant="mha", **kw):
    jb, jparams, tb, tparams = _setup(variant)
    outs = {}
    for degree in (1, P):
        bundle = _sp_bundle(tb, degree) if degree > 1 else tb
        eng = ServingEngine(bundle, tparams, max_batch=2, max_len=64, device="cpu",
                            page_size=4 if paged else None, **kw)
        rng = np.random.default_rng(3)
        reqs = [eng.submit(rng.integers(1, 90, n), max_new_tokens=m)
                for n, m in ((9, 12), (5, 6), (13, 8))]
        assert len(eng.run()) == 3
        outs[degree] = [r.output for r in reqs]
    step = _legacy_step(jb)
    for r in reqs:
        assert len(r.output) == r.max_new_tokens
        assert_greedy_chain_matches(jb, jparams, r, 2, 64, step)
    assert outs[P] == outs[1]  # float32: the SP-1 engine's tokens
    return eng


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_sp_engine_chains_match_jax_oracle(mode):
    eng = _sp_engine_case(mode == "paged", prefill_chunk=4, token_budget=6)
    s = eng.stats()
    assert s["tokens"] == 26 and s["prefill_tokens"] == 8 + 4 + 12
    if mode == "paged":
        assert sum(s["pages"]["stripes_at_high_water"]) == s["pages"]["high_water"]


def test_sp_engine_paged_preemption_matches_jax_oracle():
    eng = _sp_engine_case(True, variant="gqa", prefill_chunk=4, max_pages=8)
    s = eng.stats()
    assert s["preemptions"] >= 1 and s["pages"]["pages_in_use"] == 0


def test_sp_engine_refuses_an_uneven_pool():
    _, _, tb, tparams = _setup()
    with pytest.raises(ValueError, match="multiple of the SP degree 4"):
        ServingEngine(_sp_bundle(tb, 4), tparams, max_batch=2, max_len=64, device="cpu",
                      page_size=4, max_pages=10)
    with pytest.raises(ValueError, match="multiple of the SP degree 4"):
        ServingEngine(_sp_bundle(tb, 4), tparams, max_batch=2, max_len=30, device="cpu")


# ---------------------------------------------------------------------------
# a gloo process group: one spawned process per rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 4])
def test_sp_serving_on_a_process_group(P, tmp_path):
    """Each rank's ``sp_decode`` (window 48), ``sp_decode_paged`` and
    ``sp_prefill`` on its own shard against the JAX vmap oracle's rank,
    with the bytes of the cost models; at P = 2 the reduced paged and dense
    engines, where every rank emits the SP-1 engine's tokens (greedy and at
    temperature 1) and holds only its shard; the prefix-cache engine, whose
    one copy-on-write goes from rank 0's stripe to rank 1's; and its
    snapshot restart, one shard file per rank, token-exact."""
    d, p = dense_case(P, seed=5), paged_case(P, seed=5)
    engine = P == 2
    np.savez(tmp_path / "inputs.npz", window=np.int32(48), **d,
             **{f"p_{n}": x for n, x in p.items()})
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, P, str(tmp_path / "init"),
                                           str(tmp_path / "inputs.npz"),
                                           str(tmp_path / f"rank{r}.npz"), engine))
             for r in range(P)]
    for proc in procs:
        proc.start()
    try:
        # the oracles, computed while the ranks run
        want_dec = jax_dense(d, P, window=48)[0]
        want_pre = jax_dense(d, P)[1]
        want_paged = jax_paged(p, P)
        want_engine = {}
        if engine:
            cfg = TARCHS["qwen3-1.7b"].reduced(**ENGINE_REDUCED)
            bundle = tbuild(cfg, tapi.ParallelContext(device="cpu"))
            params = bundle.init(0)
            for name, (page_size, temperature) in ENGINE_RUNS.items():
                outs, _ = engine_outputs(bundle, params, page_size, temperature)
                want_engine[name] = [t for o in outs for t in o]
            outs, _, copies = prefix_outputs(bundle, params)
            want_engine["prefix"] = [t for o in outs for t in o]
            assert copies == [(3, 4)]  # the stripes of P = 2 are [0, 4) and [4, 8)
        for proc in procs:
            proc.join(SPAWN_TIMEOUT_S)
        assert all(proc.exitcode == 0 for proc in procs), [proc.exitcode for proc in procs]
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    dec_cost = jdec.decode_comm_cost(B, 1, HQ, HKV, D, P)
    pre_cost = jdec.prefill_comm_cost(B, 4, HQ, HKV, D, P)
    for r in range(P):
        got = np.load(tmp_path / f"rank{r}.npz")
        for key, want in (("decode", want_dec), ("paged", want_paged), ("prefill", want_pre)):
            np.testing.assert_allclose(got[key], np.asarray(want[0][r]),
                                       err_msg=f"rank {r} {key}", **F32)
        for key, cost in (("decode", dec_cost), ("paged", dec_cost), ("prefill", pre_cost)):
            assert list(got[f"{key}/bytes"]) == [cost.fwd_bytes, cost.bwd_bytes], (r, key)
        for name, (page_size, _) in ENGINE_RUNS.items() if engine else ():
            assert got[f"engine/{name}"].tolist() == want_engine[name], (r, name)
            held = tuple(got[f"engine/{name}/held"])
            n_pages = ENGINE_KW["max_batch"] * -(-ENGINE_KW["max_len"] // 4)
            assert held == ((n_pages // P, 4) if page_size else
                            (ENGINE_KW["max_batch"], ENGINE_KW["max_len"] // P)), (r, name)
        if engine:
            assert got["prefix"].tolist() == want_engine["prefix"], r
            assert got["prefix/copies"].tolist() == [[3, 4]], r
            assert got["snapshot"].tolist() == want_engine["prefix"], r
            assert int(got["prefix/audit"]) == int(got["snapshot/audit"]) == 0, r
    if engine:
        step = sorted(os.listdir(tmp_path / "snapshot"))[0]
        assert sorted(os.listdir(tmp_path / "snapshot" / step)) == [
            "manifest.json", "proc_00000.npz", "proc_00001.npz"]
        with np.load(tmp_path / "snapshot" / step / "proc_00001.npz") as z:
            assert z["k"].shape[1] == 8 // P  # each rank's file holds its stripe


# ---------------------------------------------------------------------------
# the serve CLI's plan line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("page_size", [None, 16])
def test_serve_cli_prints_the_reference_plan_line(page_size, capsys):
    from repro.configs import ARCHS as JARCHS
    from repro.launch.serve import print_serving_plan as jprint
    from repro_torch.launch.serve import print_serving_plan as tprint

    for arch, reduced in (("qwen3-1.7b", False), ("qwen3-1.7b", True), ("llama2-7b", False)):
        tcfg, jcfg = TARCHS[arch], JARCHS[arch]
        if reduced:
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        kw = dict(max_batch=8, chunk=256, max_len=2048, page_size=page_size)
        tprint(tcfg, **kw)
        got = capsys.readouterr().out
        jprint(jcfg, **kw)
        assert got == capsys.readouterr().out
        assert got.startswith("serving plan @ SP=4")

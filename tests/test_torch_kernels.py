"""The port's attention kernels (plain versions), merge and page-table
arithmetic against the JAX package, on the same numpy inputs.

The CUDA kernels themselves need the card: ``chip_smoke.py`` holds them
against these plain versions there.  Here the plain versions are held
against ``repro``'s ``impl="xla"`` path and, once per kernel, against the
Pallas kernel body run in interpret mode.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import merge as jmerge
from repro.core.zigzag import zigzag_positions
from repro.kernels import ops as jops
from repro.serving import kv_cache as jkv
from repro_torch.core import merge as tmerge
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import PAD_POS, attention_reference
from repro_torch.serving import kv_cache as tkv

F32_OUT = dict(atol=2e-5, rtol=2e-5)
F32_LSE = dict(atol=1e-4, rtol=1e-4)

SHAPES = [
    # B, Sq, Sk, Hq, Hkv, D  (tests/test_kernels.py::SHAPES)
    (1, 128, 128, 1, 1, 64),
    (2, 256, 256, 4, 2, 64),
    (1, 128, 256, 4, 1, 128),
    (1, 512, 512, 2, 2, 128),
]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _pair(a):
    """The same numpy array as a JAX and a torch (CPU) array."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _run_flash(q, k, v, q_pos, k_pos, *, impl="xla", **kw):
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(k), _pair(v)
    jqp = None if q_pos is None else jnp.asarray(q_pos)
    jkp = None if k_pos is None else jnp.asarray(k_pos)
    tqp = None if q_pos is None else torch.from_numpy(np.array(q_pos, np.int32))
    tkp = None if k_pos is None else torch.from_numpy(np.array(k_pos, np.int32))
    want = jops.flash_attention(jq, jk, jv, q_pos=jqp, k_pos=jkp, impl=impl, **kw)
    got = tops.flash_attention(tq, tk, tv, q_pos=tqp, k_pos=tkp, impl="torch", **kw)
    return got, want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax(shape, causal):
    B, Sq, Sk, Hq, Hkv, D = shape
    rng = _rng("flash", shape, causal)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    (out, lse), (jout, jlse) = _run_flash(q, k, v, None, None, causal=causal,
                                          block_q=128, block_k=128)
    _close(out, jout, **F32_OUT)
    _close(lse, jlse, **F32_LSE)


@pytest.mark.parametrize("case", ["zigzag", "window", "pad_rows"])
def test_flash_plain_positions_match_jax(case):
    """Zigzag positions, a sliding window, and rows that see no key at all
    (every key PAD or in the future) -> exactly (0, -inf)."""
    B, S, H, D = 2, 256, 2, 64
    rng = _rng("flash-pos", case)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    kw = dict(causal=True, block_q=64, block_k=64)
    pos = np.arange(S, dtype=np.int32)
    q_pos = k_pos = np.broadcast_to(pos, (B, S))
    if case == "zigzag":
        z = np.concatenate([np.asarray(zigzag_positions(S, 4, j)) for j in range(4)])
        q_pos = k_pos = np.broadcast_to(z.astype(np.int32), (B, S))
    elif case == "window":
        kw["window"] = 48
    else:
        k_pos = np.array(np.broadcast_to(pos, (B, S)))
        k_pos[1] = PAD_POS  # row 1: every key is padding
        q_pos = np.array(q_pos)
        q_pos[0, :16] = -1  # row 0: the first 16 queries precede every key
    (out, lse), (jout, jlse) = _run_flash(q, k, v, q_pos, k_pos, **kw)
    _close(out, jout, **F32_OUT)
    _close(lse, jlse, **F32_LSE)
    if case == "pad_rows":
        for dead in (out[1], out[0, :16]):
            assert torch.equal(dead, torch.zeros_like(dead))
        assert torch.isneginf(lse[1]).all() and torch.isneginf(lse[0, :16]).all()


def test_flash_plain_matches_pallas_interpret():
    """One small case against the Pallas kernel body itself."""
    B, S, Hq, Hkv, D = 1, 64, 4, 2, 32
    rng = _rng("flash-pallas")
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    (out, lse), (jout, jlse) = _run_flash(q, k, v, None, None, impl="pallas_interpret",
                                          causal=True, block_q=32, block_k=32)
    _close(out, jout, **F32_OUT)
    _close(lse, jlse, **F32_LSE)


def test_flash_reference_matches_jax():
    from repro.kernels.ref import attention_reference as jref

    rng = _rng("ref")
    q = rng.standard_normal((2, 32, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 48, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 48, 2, 32)).astype(np.float32)
    q_pos = np.array(np.broadcast_to(np.arange(16, 48, dtype=np.int32), (2, 32)))
    got = attention_reference(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                              q_pos=torch.from_numpy(q_pos), window=20)
    want = jref(*(jnp.asarray(x) for x in (q, k, v)), causal=True, q_pos=jnp.asarray(q_pos),
                window=20)
    for g, w in zip(got, want):
        _close(g, w, **F32_OUT)


# ---------------------------------------------------------------------------
# paged decode (tests/test_kernels.py::PAGED_CASES and its data generator)
# ---------------------------------------------------------------------------

PAGED_CASES = [
    ("ps1_mha", 1, (2, 2), (1, 3), None),
    ("ps4_gqa", 4, (8, 2), (3, 4, 5), None),
    ("ps8_mqa", 8, (4, 1), (8, 23), None),
    ("ps16_boundary", 16, (4, 4), (15, 16, 17, 64), None),
    ("ps8_window", 8, (4, 2), (40, 7), 16),
]


def paged_case_data(case_id, ps, heads, lengths, D=32):
    """Pool state shaped like real serving state: pages assigned in reversed
    order, sentinel table tails, random K/V under PAD_POS in unwritten slots."""
    Hq, Hkv = heads
    B = len(lengths)
    W = max(-(-L // ps) for L in lengths) + 1
    n_pages = sum(-(-L // ps) for L in lengths) + 2
    rng = np.random.default_rng(zlib.crc32(repr((case_id, ps, heads, tuple(lengths))).encode()))
    k_pool = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    pos_pool = np.full((n_pages, ps), PAD_POS, np.int32)
    bt = np.full((B, W), n_pages, np.int32)
    free = list(range(n_pages))
    for b, L in enumerate(lengths):
        pages = [free.pop() for _ in range(-(-L // ps))][::-1]
        for ip, pg in enumerate(pages):
            bt[b, ip] = pg
            for off in range(ps):
                if ip * ps + off < L:
                    pos_pool[pg, off] = ip * ps + off
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    q_pos = (np.asarray(lengths, np.int32) - 1)[:, None]
    return q, k_pool, v_pool, pos_pool, bt, q_pos


def _run_paged(data, lengths, window, impl="xla"):
    pairs = [_pair(x) for x in data]
    jl, tl = _pair(np.asarray(lengths, np.int32))
    want = jops.paged_decode_attention(*(p[0] for p in pairs), lengths=jl, window=window,
                                       impl=impl)
    got = tops.paged_decode_attention(*(p[1] for p in pairs), lengths=tl, window=window,
                                      impl="torch")
    return got, want


@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_plain_matches_jax(case):
    case_id, ps, heads, lengths, window = case
    (out, lse), (jout, jlse) = _run_paged(paged_case_data(case_id, ps, heads, lengths),
                                          lengths, window)
    _close(out, jout, **F32_OUT)
    _close(lse, jlse, **F32_LSE)


def test_paged_plain_matches_pallas_interpret():
    case_id, ps, heads, lengths, window = PAGED_CASES[1]
    (out, lse), (jout, jlse) = _run_paged(paged_case_data(case_id, ps, heads, lengths),
                                          lengths, window, impl="pallas_interpret")
    _close(out, jout, **F32_OUT)
    _close(lse, jlse, **F32_LSE)


def test_paged_plain_dead_row_and_alias_poison():
    """A fully unmapped row is exactly (0, -inf), and the page a clamped
    sentinel would alias (live-looking, huge K/V) never leaks."""
    q, k_pool, v_pool, pos_pool, bt, q_pos = paged_case_data("dead", 4, (4, 2), (9, 5))
    n_pages = k_pool.shape[0]
    bt[1, :] = n_pages
    k_pool[n_pages - 1] = 1e3
    v_pool[n_pages - 1] = 1e3
    pos_pool[n_pages - 1] = 0
    (out, lse), (jout, jlse) = _run_paged((q, k_pool, v_pool, pos_pool, bt, q_pos), (9, 0),
                                          None)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert torch.isneginf(lse[1]).all()
    _close(out, jout, **F32_OUT)


def _paged_d256_poisoned():
    """Kernel C's inputs at head dim 256 as recurrentgemma-2b's 10/1 heads
    would give them at page 16: rows of 300 and 45 tokens, and a third row
    whose table is all sentinel (dead); the page a clamped sentinel would
    alias holds huge, live-looking K/V at position 0."""
    q, k_pool, v_pool, pos_pool, bt, q_pos = paged_case_data("d256_g10", 16, (10, 1),
                                                             (300, 45, 9), D=256)
    n_pages = k_pool.shape[0]
    bt[2, :] = n_pages
    k_pool[n_pages - 1] = 1e3
    v_pool[n_pages - 1] = 1e3
    pos_pool[n_pages - 1] = 0
    return (q, k_pool, v_pool, pos_pool, bt, q_pos), (300, 45, 0)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_paged_plain_d256_matches_jax(impl):
    """The plain paged version at D 256 (group 10, one KV head, page 16)
    against the JAX XLA path and the Pallas kernel in interpret mode: the
    dead row exactly (0, -inf), the aliased page never leaking into it."""
    data, lengths = _paged_d256_poisoned()
    (out, lse), (jout, jlse) = _run_paged(data, lengths, None, impl=impl)
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    assert torch.isneginf(lse[2]).all() and np.isneginf(np.asarray(jlse)[2]).all()
    _close(out, jout, **F32_OUT)
    _close(lse[:2], np.asarray(jlse)[:2], **F32_LSE)


def test_pick_block_matches_jax():
    from repro.kernels.ops import _pick_block

    for s, t in [(1024, 512), (1536, 512), (24, 16), (1, 512), (384, 512), (8, 4)]:
        assert tops.pick_block(s, t) == _pick_block(s, t)
    for s, t in [(1023, 512), (1026, 512), (1028, 512), (6, 4)]:
        with pytest.raises(ValueError, match="no power-of-two tile"):
            tops.pick_block(s, t)


def test_cuda_impl_on_cpu_tensors_raises():
    x = torch.zeros((1, 8, 1, 32))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tops.flash_attention(x, x, x, impl="cuda")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tops.paged_decode_attention(x[:, :1], x, x, torch.zeros((1, 8), dtype=torch.int32),
                                    torch.zeros((1, 1), dtype=torch.int32),
                                    torch.zeros((1, 1), dtype=torch.int32), impl="cuda")


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def test_merge_and_finalize_match_jax():
    rng = _rng("merge")
    shape = (2, 5, 3, 8)
    oa, ob = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    la, lb = (rng.standard_normal(shape[:-1]).astype(np.float32) * 3 for _ in range(2))
    la[0, 0] = -np.inf  # one side empty
    lb[0, 1] = -np.inf
    la[1, 2] = lb[1, 2] = -np.inf  # both empty
    oa[1, 2] = 0.0
    ob[1, 2] = 0.0
    args = [_pair(x) for x in (oa, la, ob, lb)]
    got = tmerge.merge_partials(*(a[1] for a in args))
    want = jmerge.merge_partials(*(a[0] for a in args))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-6, rtol=1e-6)
    got_f = tmerge.finalize(*got)
    want_f = jmerge.finalize(*want)
    for g, w in zip(got_f, want_f):
        _close(g, w, atol=1e-6, rtol=1e-6)
    assert torch.isneginf(got[1][1, 2]).all()
    e_out, e_lse = tmerge.empty_partial(shape)
    m_out, m_lse = tmerge.merge_partials(e_out, e_lse, *(a[1] for a in args[2:]))
    _close(m_out, np.where(np.isneginf(lb)[..., None], 0.0, ob), atol=1e-6, rtol=1e-6)
    _close(m_lse, lb, atol=1e-6, rtol=1e-6)


MERGE_GRAD_CASES = ([("a_empty", -np.inf, x) for x in (-10.0, -100.0, -1000.0)]
                    + [("b_empty", x, -np.inf) for x in (-10.0, -100.0, -1000.0)]
                    + [("both_empty", -np.inf, -np.inf), ("both_finite", -3.0, 2.5)])


@pytest.mark.parametrize("case", MERGE_GRAD_CASES,
                         ids=[f"{c[0]}_{c[1] if c[0] != 'a_empty' else c[2]}"
                              for c in MERGE_GRAD_CASES])
def test_merge_gradients_match_jax(case):
    """Gradients of both outs and both lses through the merge, against
    ``jax.grad`` of the reference: finite beside an empty partial whatever
    the other side's lse (the empty lane must never reach exp(0 - m))."""
    import jax

    _, lse_a, lse_b = case
    rng = _rng("merge_grad", case[0])
    shape = (2, 3, 2, 4)
    oa, ob, w = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    wl = rng.standard_normal(shape[:-1]).astype(np.float32)
    la = np.full(shape[:-1], lse_a, np.float32) + (0 if np.isinf(lse_a) else
                                                   rng.standard_normal(shape[:-1]).astype(np.float32))
    lb = np.full(shape[:-1], lse_b, np.float32) + (0 if np.isinf(lse_b) else
                                                   rng.standard_normal(shape[:-1]).astype(np.float32))

    def jloss(oa, la, ob, lb):
        o, l = jmerge.merge_partials(oa, la, ob, lb)
        return jnp.sum(o * w) + jnp.sum(jnp.where(jnp.isneginf(l), 0.0, l) * wl)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (oa, la, ob, lb)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (oa, la, ob, lb)]
    o, l = tmerge.merge_partials(*ts)
    loss = (o * torch.from_numpy(w)).sum() + (torch.where(torch.isneginf(l), 0.0, l)
                                              * torch.from_numpy(wl)).sum()
    got = torch.autograd.grad(loss, ts)
    for name, g, x in zip(("d out_a", "d lse_a", "d out_b", "d lse_b"), got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-6, rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# page-table arithmetic and the allocator: exact equality
# ---------------------------------------------------------------------------


def test_page_table_arithmetic_matches_jax():
    q, k_pool, v_pool, pos_pool, bt, q_pos = paged_case_data("arith", 4, (2, 2), (9, 5, 1))
    n_pages, ps = pos_pool.shape
    bt[2, 3] = 0  # a stale mapping beyond row 2's used length
    lengths = np.asarray([9, 5, 1], np.int32)
    jbt, tbt = _pair(bt)
    for lens in (None, lengths):
        jl = None if lens is None else jnp.asarray(lens)
        tl = None if lens is None else torch.from_numpy(lens)
        jv = jkv.view_indices(jbt, ps, lengths=jl)
        tv = tkv.view_indices(tbt, ps, lengths=tl)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tkv.gather_pages(torch.from_numpy(k_pool), tv).numpy(),
                                      np.asarray(jkv.gather_pages(jnp.asarray(k_pool), jv)))
        np.testing.assert_array_equal(
            tkv.gather_positions(torch.from_numpy(pos_pool), tv).numpy(),
            np.asarray(jkv.gather_positions(jnp.asarray(pos_pool), jv)))
    slots = np.asarray([[8, 9, 12, 40], [4, 5, 6, 7], [0, 1, 2, 3]], np.int32)
    valid = np.asarray([[1, 1, 1, 1], [1, 1, 0, 1], [1, 0, 0, 0]], bool)
    for sl, va in ((slots, valid), (slots[:, 0], valid[:, 1])):
        jp, jo = jkv.write_coords(jbt, jnp.asarray(sl), jnp.asarray(va), n_pages, ps)
        tp, to = tkv.write_coords(tbt, torch.from_numpy(np.ascontiguousarray(sl)),
                                  torch.from_numpy(np.ascontiguousarray(va)), n_pages, ps)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_page_allocator_matches_jax():
    ja, ta = jkv.PageAllocator(6), tkv.PageAllocator(6)
    for op, arg in [("alloc", 3), ("free", [1]), ("alloc", 2), ("free", [0, 2]),
                    ("defrag", None), ("alloc", 3)]:
        if op == "alloc":
            assert ta.alloc(arg) == ja.alloc(arg)
        elif op == "free":
            ta.free(arg)
            ja.free(arg)
        else:
            ta.defrag_order()
            ja.defrag_order()
        assert ta.utilization() == ja.utilization()
    with pytest.raises(MemoryError):
        ta.alloc(5)
    with pytest.raises(tkv.PageAllocatorError, match="double free"):
        ta.free([ta.alloc(1)[0]] * 2)
    with pytest.raises(tkv.PageAllocatorError, match="out of range"):
        ta.free([99])
    assert tkv.pages_for(0, 4) == jkv.pages_for(0, 4) == 1
    assert tkv.pages_for(9, 4) == jkv.pages_for(9, 4) == 3


# ---------------------------------------------------------------------------
# the kernels' skip and mask predicates
# ---------------------------------------------------------------------------


def test_tile_and_page_predicates_match_jax():
    import importlib

    jfa = importlib.import_module("repro.kernels.flash_attention")
    jpa = importlib.import_module("repro.kernels.paged_attention")
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import paged_attention as tpa

    rng = _rng("predicates")
    for _ in range(40):
        qp = rng.integers(0, 64, 8).astype(np.int32)
        kp = rng.integers(0, 96, 8).astype(np.int32)
        if rng.random() < 0.3:
            kp[:] = PAD_POS
        elif rng.random() < 0.3:
            kp[rng.random(8) < 0.5] = PAD_POS
        for causal in (False, True):
            for window in (None, 16):
                jq, jk = jnp.asarray(qp), jnp.asarray(kp)
                tq, tk = torch.from_numpy(qp), torch.from_numpy(kp)
                assert tfa.tile_skip(tq, tk, causal=causal, window=window) == bool(
                    jfa.tile_skip(jq, jk, causal=causal, window=window))
                got = tfa.tile_mask(tq, tk, causal=causal, window=window).numpy()
                want = jfa.tile_mask(jq, jk, causal=causal, window=window)
                np.testing.assert_array_equal(got, np.broadcast_to(want, got.shape))
            q1 = int(qp[0])
            for entry in (0, 5, 6, 9):
                assert tpa.page_skip(entry, tk, q1, n_pages=6, window=window) == bool(
                    jpa.page_skip(entry, jk, q1, n_pages=6, window=window))
            np.testing.assert_array_equal(tpa.page_mask(tk, q1, window=16).numpy(),
                                          np.asarray(jpa.page_mask(jk, q1, window=16)))

"""The split-and-merge order of the decode core (``csrc/decode.cuh``: kernel
A's decode instance and kernel C), emulated in plain torch, held against the
JAX package on the same inputs.

Both kernels cut the KV range into the splits that
``decode_split_rule`` gives (here for a card of 132 SMs), compute each
split's partial ``(out / l, m + log l)`` by the online softmax over 32-key
tiles (keys past the range or behind an unmapped block-table entry are
zero-filled padding), and merge the partials in split order with the
lse-weighted Update(): ``w_s = exp(lse_s - max)``, ``out = sum w_s out_s /
sum w_s``, ``lse = max + log(sum w_s)``.  :func:`emulate_decode` repeats
that order; the kernels themselves are held against the plain versions on
the card (``chip_smoke.py`` phases 3 and 4).

bf16 calls at head dim 256 run on the cluster instance
(``csrc/decode_d256.cuh``) instead: each unit's key range is cut into the
blocks of one cluster by ``decode_rule_d256``, each block's partial comes
from the same online softmax over 32-key tiles with the scale applied to S
in float32 and P rounded to bf16 for the P V product (l from the unrounded
P), and the partials merge in block order with the running Update().
:func:`emulate_decode_d256` repeats that order (chip_smoke.py phases 4 and
20 (a) hold the kernel itself).

Tolerances are ``chip_smoke.tolerances``: float32 out 1e-4 + 1e-4·|ref| and
lse 1e-4 (the arithmetic is float32 on both sides, only the order of sums
differs); bf16 out 5e-3 + 1e-2·|ref| (one bf16 rounding of out) and lse 1e-3.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import PAGED_CASES, _paged_case_data

from repro.kernels import ops as jops
from repro.kernels.paged_attention import paged_decode_fwd_pallas
from repro_torch.kernels.flash_attention import (
    DECODE_D256_MAX_CLUSTER,
    DECODE_TILE_KEYS,
    decode_core_instance,
    decode_rule_d256,
    decode_split_rule,
    decode_units,
    flash_attention_fwd_torch,
)
from repro_torch.kernels.ref import NEG_INF, PAD_POS, visibility_mask

SM_COUNT = 132  # H100 SXM
TOL = {
    torch.float32: (dict(atol=1e-4, rtol=1e-4), dict(atol=1e-4, rtol=0.0)),
    torch.bfloat16: (dict(atol=5e-3, rtol=1e-2), dict(atol=1e-3, rtol=0.0)),
}


def _split_partial(q, k, v, q_pos, k_pos, *, causal, window, scale):
    """One split's normalised partial over 32-key tiles, the range padded to
    whole tiles with zero keys at PAD_POS."""
    B, n = k_pos.shape
    pad = -n % DECODE_TILE_KEYS
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad, *k.shape[2:]))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad, *v.shape[2:]))], dim=1)
        k_pos = torch.cat([k_pos, k_pos.new_full((B, pad), PAD_POS)], dim=1)
    return flash_attention_fwd_torch(q, k, v, q_pos, k_pos, causal=causal, window=window,
                                     scale=scale, block_k=DECODE_TILE_KEYS)


def emulate_decode(q, k, v, q_pos, k_pos, *, causal, window, scale, sm_count=SM_COUNT):
    """Split-and-merge of the decode core on ``q (B,Sq,Hq,D)``, ``k/v
    (B,Sk,Hkv,D)`` -> ``(out in q's type, lse f32)``; returns the split count
    too."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    per, splits = decode_split_rule(Sk, decode_units(B, Hq, Hkv, Sq), sm_count)
    qf, kf, vf = q.float(), k.float(), v.float()
    parts = []
    for s in range(splits):
        lo, hi = s * per * DECODE_TILE_KEYS, min(Sk, (s + 1) * per * DECODE_TILE_KEYS)
        if lo >= hi:
            parts.append((torch.zeros((B, Sq, Hq, D)), torch.full((B, Sq, Hq), -torch.inf)))
            continue
        parts.append(_split_partial(qf, kf[:, lo:hi], vf[:, lo:hi], q_pos, k_pos[:, lo:hi],
                                    causal=causal, window=window, scale=scale))
    lse_s = torch.stack([p[1] for p in parts])
    mx = lse_s.max(dim=0).values
    num = torch.zeros((B, Sq, Hq, D))
    den = torch.zeros((B, Sq, Hq))
    for o, ls in parts:
        live = ~torch.isneginf(ls)
        w = torch.where(live, torch.exp(ls - torch.where(live, mx, 0.0)), 0.0)
        num = num + w[..., None] * o
        den = den + w
    valid = den > 0
    out = torch.where(valid[..., None], num / torch.where(valid, den, 1.0)[..., None], 0.0)
    lse = torch.where(valid, mx + torch.log(torch.where(valid, den, 1.0)), -torch.inf)
    return out.to(q.dtype), lse, splits


def _check(got, want_out, want_lse, dtype, tol_lse=None):
    out, lse = got
    want_lse = np.asarray(want_lse)
    dead = np.isneginf(want_lse)
    np.testing.assert_array_equal(torch.isneginf(lse).numpy(), dead)
    out_f = out.float().numpy()
    assert (out_f[dead] == 0).all()
    tol_out, tol_lse = TOL[dtype][0], tol_lse or TOL[dtype][1]
    np.testing.assert_allclose(out_f, np.asarray(want_out), **tol_out)
    np.testing.assert_allclose(lse.numpy()[~dead], want_lse[~dead], **tol_lse)


def _decode_inputs(key, B, Sq, Sk, Hq, Hkv, D, layout):
    """Seeded numpy inputs: each batch row's used length in [1, Sk] (the
    first is Sk), padding after it, the Sq queries at the last positions.
    "dead": batch row 1 is all padding and the first query of batch row 0
    precedes every key."""
    rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    lengths = rng.integers(1, Sk + 1, B)
    lengths[0] = Sk
    ar = np.arange(Sk, dtype=np.int32)[None]
    k_pos = np.where(ar < lengths[:, None], ar, PAD_POS).astype(np.int32)
    q_pos = (lengths[:, None] - Sq + np.arange(Sq)[None]).astype(np.int32)
    if layout == "dead":
        k_pos[1] = PAD_POS
        q_pos[0, 0] = -1
    return q, k, v, q_pos, k_pos


# id, (B, Sq, Sk, Hq, Hkv, D), causal, window, layout: GQA groups 1/2/8 at
# Sq 1 and 3, a window, dead rows, an Sk that is no multiple of a split (nor
# of a tile), an Sk shorter than one tile, a non-causal call.
DECODE_CASES = [
    (f"g{Hq // Hkv}_sq{Sq}", (2, Sq, 200, Hq, Hkv, 32), True, None, "lengths")
    for Sq in (1, 3) for Hq, Hkv in ((2, 2), (4, 2), (8, 1))
] + [
    ("window", (2, 3, 200, 4, 2, 32), True, 24, "lengths"),
    ("dead_rows", (3, 3, 136, 4, 2, 32), True, None, "dead"),
    ("ragged_sk", (1, 1, 1000, 8, 1, 64), True, None, "lengths"),
    ("sk_below_tile", (2, 1, 20, 4, 2, 32), True, None, "lengths"),
    ("noncausal", (2, 3, 72, 4, 2, 32), False, None, "lengths"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_split_merge_matches_jax(case, dtype):
    case_id, (B, Sq, Sk, Hq, Hkv, D), causal, window, layout = case
    q, k, v, q_pos, k_pos = _decode_inputs(case_id, B, Sq, Sk, Hq, Hkv, D, layout)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    out, lse, splits = emulate_decode(tq, tk, tv, torch.from_numpy(q_pos),
                                      torch.from_numpy(k_pos), causal=causal, window=window,
                                      scale=1.0 / D ** 0.5)
    if case_id != "sk_below_tile":
        assert splits > 1  # the merge is exercised
    qn, kn, vn = (t.float().numpy() for t in (tq, tk, tv))
    want = jops.flash_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                                causal=causal, window=window, impl="xla", block_q=Sq,
                                block_k=512)
    _check((out, lse), *want, dtype)
    if layout == "dead":
        assert torch.isneginf(lse[1]).all() and (out[1] == 0).all()
        assert torch.isneginf(lse[0, 0]).all() and (out[0, 0] == 0).all()


def test_decode_split_merge_matches_pallas_interpret():
    """One case against the Pallas forward in interpret mode, as
    tests/test_kernels.py runs it on the CPU."""
    B, Sq, Sk, Hq, Hkv, D = 2, 3, 256, 4, 2, 64
    q, k, v, q_pos, k_pos = _decode_inputs("interpret", B, Sq, Sk, Hq, Hkv, D, "lengths")
    out, lse, splits = emulate_decode(*(torch.from_numpy(x) for x in (q, k, v, q_pos, k_pos)),
                                      causal=True, window=None, scale=1.0 / D ** 0.5)
    assert splits > 1
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos), causal=True,
                                impl="pallas_interpret", block_q=Sq, block_k=128)
    _check((out, lse), *want, torch.float32)


def emulate_paged(q, k_pool, v_pool, pos_pool, block_tables, q_pos, *, window, scale,
                  sm_count=SM_COUNT, emulate=emulate_decode):
    """Kernel C's order: the request's logical key range ``W * ps`` through
    the block table (unmapped entries are zero keys at PAD_POS, their pool
    never read), then ``emulate`` (:func:`emulate_decode`, or
    :func:`emulate_decode_d256` for the cluster instance) over it, causal."""
    n_pages, ps = pos_pool.shape
    B, W = block_tables.shape
    j = torch.arange(W * ps)
    entry = block_tables[:, j // ps]  # (B, W*ps), raw
    mapped = (entry >= 0) & (entry < n_pages)
    row = torch.where(mapped, entry, 0) * ps + j % ps
    k = torch.where(mapped[..., None, None], k_pool.reshape(n_pages * ps, *k_pool.shape[2:])[row],
                    0.0)
    v = torch.where(mapped[..., None, None], v_pool.reshape(n_pages * ps, *v_pool.shape[2:])[row],
                    0.0)
    k_pos = torch.where(mapped, pos_pool.reshape(-1)[row], PAD_POS).to(torch.int32)
    return emulate(q, k.to(q.dtype), v.to(q.dtype), q_pos, k_pos, causal=True,
                   window=window, scale=scale, sm_count=sm_count)


# The JAX package's cases, and an MQA group of 32 (kernel C takes any group:
# the decode core holds the group in chunks of 64 rows).
PORT_PAGED_CASES = PAGED_CASES + [("ps16_group32_mqa", 16, (32, 1), (300, 40), None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", PORT_PAGED_CASES, ids=[c[0] for c in PORT_PAGED_CASES])
def test_paged_split_merge_matches_pallas_interpret(case, dtype):
    case_id, ps, heads, lengths, window = case
    data = _paged_case_data(case_id, ps, heads, lengths)
    q, k_pool, v_pool = (torch.from_numpy(np.array(x)).to(dtype) for x in data[:3])
    pos_pool, bt, q_pos = (torch.from_numpy(np.array(x)) for x in data[3:])
    D = q.shape[-1]
    out, lse, _ = emulate_paged(q, k_pool, v_pool, pos_pool, bt, q_pos, window=window,
                                scale=1.0 / D ** 0.5)
    widened = [jnp.asarray(t.float().numpy()) for t in (q, k_pool, v_pool)]
    want = paged_decode_fwd_pallas(*widened, *data[3:], window=window, interpret=True)
    _check((out, lse), *want, dtype)


def test_paged_split_merge_unmapped_row_is_merge_identity():
    """An unmapped row is exactly (0, -inf), and the page a clamped sentinel
    would alias (huge, live-looking K/V) never leaks into it."""
    data = [np.array(x) for x in _paged_case_data("dead", 4, (4, 2), (9, 5))]
    n_pages = data[1].shape[0]
    data[4][1, :] = n_pages
    data[1][n_pages - 1] = 1e3
    data[2][n_pages - 1] = 1e3
    data[3][n_pages - 1] = 0
    t = [torch.from_numpy(x) for x in data]
    out, lse, _ = emulate_paged(*t, window=None, scale=32 ** -0.5)
    want = paged_decode_fwd_pallas(*(jnp.asarray(x) for x in data), interpret=True)
    # Row 0's scores reach several hundred here (K = 1e3), and one float32
    # step at |lse| ~ 700 is 6e-5: the two dot-product orders put lse up to
    # a few such steps apart, so lse is held to 1e-4 plus 1e-6 of itself.
    _check((out, lse), *want, torch.float32, tol_lse=dict(atol=1e-4, rtol=1e-6))
    assert (out[1] == 0).all() and torch.isneginf(lse[1]).all()


@pytest.mark.parametrize("n_keys,units,want", [
    (2048, 64, (8, 8)),  # qwen3-1.7b serving decode: B=8 x 8 KV heads
    (2064, 64, (8, 9)),  # its paged call: W=129 pages of 16
    (20, 64, (1, 1)),  # shorter than one tile
    (0, 4, (1, 1)),  # no keys: one split of one (dead) tile
    (1000, 6, (1, 32)),  # every tile its own split
    (1 << 20, 1024, (64, 512)),  # capped at 64 tiles a split
])
def test_decode_split_rule(n_keys, units, want):
    assert decode_split_rule(n_keys, units, SM_COUNT) == want
    per, splits = want
    n_tiles = max(1, -(-n_keys // DECODE_TILE_KEYS))
    assert (splits - 1) * per < n_tiles <= splits * per


def test_decode_units_row_chunks():
    assert decode_units(8, 16, 8, 1) == 64  # group 2: one chunk of 2 rows
    assert decode_units(2, 32, 1, 4) == 4  # 128 rows: two chunks of 64


# ---------------------------------------------------------------------------
# the cluster instance (bf16 at head dim 256)
# ---------------------------------------------------------------------------


def _block_partial(q, k, v, q_pos, k_pos, *, causal, window, scale, round_p):
    """One block's normalised partial ``(out / l, m + log l)`` over its
    32-key tiles, in float32: S from the inputs, then scaled and masked, the
    online softmax a tile at a time, P rounded to bf16 for the P V product
    when ``round_p`` (l sums the unrounded P)."""
    B, Sq, Hq, D = q.shape
    n, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qf = q.float()
    acc = torch.zeros((B, Hq, Sq, D))
    m = torch.full((B, Hq, Sq), NEG_INF)
    l = torch.zeros((B, Hq, Sq))
    for k0 in range(0, n, DECODE_TILE_KEYS):
        kb = k[:, k0:k0 + DECODE_TILE_KEYS].float().repeat_interleave(group, dim=2)
        vb = v[:, k0:k0 + DECODE_TILE_KEYS].float().repeat_interleave(group, dim=2)
        mask = visibility_mask(q_pos, k_pos[:, k0:k0 + DECODE_TILE_KEYS], causal=causal,
                               window=window)[:, None]
        s = torch.where(mask, torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - safe[..., None]), 0.0)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(torch.clamp(m - safe, max=0.0)))
        l = alpha * l + p.sum(dim=-1)
        pv = p.to(torch.bfloat16).float() if round_p else p
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", pv, vb)
        m = m_new
    valid = l > 0
    out = torch.where(valid[..., None], acc / torch.where(valid, l, 1.0)[..., None], 0.0)
    lse = torch.where(valid, m + torch.log(torch.where(valid, l, 1.0)), -torch.inf)
    return out.transpose(1, 2), lse.transpose(1, 2)


def emulate_decode_d256(q, k, v, q_pos, k_pos, *, causal, window, scale, sm_count=SM_COUNT):
    """The cluster instance's order on ``q (B,Sq,Hq,D)``, ``k/v
    (B,Sk,Hkv,D)`` -> ``(out in q's type, lse f32, cluster)``: block ``r``
    of a unit's cluster takes tiles ``[r*per, (r+1)*per)``, and the blocks'
    partials merge in block order, as a running sum (rows dead in a block
    are skipped; dead everywhere stay (0, -inf))."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    per, cluster = decode_rule_d256(Sk, decode_units(B, Hq, Hkv, Sq), sm_count)
    span = per * DECODE_TILE_KEYS
    pad = cluster * span - Sk  # zero keys at PAD_POS up to whole tiles
    k = torch.cat([k, k.new_zeros((B, pad, Hkv, D))], dim=1)
    v = torch.cat([v, v.new_zeros((B, pad, Hkv, D))], dim=1)
    k_pos = torch.cat([k_pos, k_pos.new_full((B, pad), PAD_POS)], dim=1)
    mx = torch.full((B, Sq, Hq), -torch.inf)
    num = torch.zeros((B, Sq, Hq, D))
    den = torch.zeros((B, Sq, Hq))
    for r in range(cluster):
        keys = slice(r * span, (r + 1) * span)
        o, ls = _block_partial(q, k[:, keys], v[:, keys], q_pos, k_pos[:, keys], causal=causal,
                               window=window, scale=scale, round_p=q.dtype == torch.bfloat16)
        live = ~torch.isneginf(ls)
        M = torch.where(live, torch.maximum(mx, ls), mx)
        rs = torch.where(live, torch.exp(mx - M), 1.0)
        w = torch.where(live, torch.exp(ls - M), 0.0)
        num = w[..., None] * o + num * rs[..., None]
        den = den * rs + w
        mx = M
    valid = den > 0
    out = torch.where(valid[..., None], num / torch.where(valid, den, 1.0)[..., None], 0.0)
    lse = torch.where(valid, mx + torch.log(torch.where(valid, den, 1.0)), -torch.inf)
    return out.to(q.dtype), lse, cluster


def _ring_inputs(key, B, Hq, Hkv, D, slots, lengths):
    """Seeded numpy inputs over a ring buffer of ``slots`` slots after each
    row's ``length`` tokens (slot p % slots holds the last position written
    to it, unwritten slots PAD_POS; a row of length 0 sees no key)."""
    rng = np.random.default_rng(zlib.crc32(repr(key).encode()))
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, Hq, D), (B, slots, Hkv, D), (B, slots, Hkv, D)))
    k_pos = np.full((B, slots), PAD_POS, np.int32)
    for b, n in enumerate(lengths):
        p = np.arange(max(0, n - slots), n)
        k_pos[b, p % slots] = p
    q_pos = np.array([[max(n - 1, 0)] for n in lengths], np.int32)
    return q, k, v, q_pos, k_pos


# id, (B, Sq, Sk, Hq, Hkv), window, layout at D 256: recurrentgemma's group
# 10 x Sq 1 over a ring buffer (a wrapped row, a half-filled one, a row
# that sees no key) with its window; groups 1, 4 (at Sq 4: 16 rows) and 16;
# a dead row; Sk no multiple of a tile (200, 136).
D256_CASES = [
    ("g10_ring", (3, 1, 1024, 10, 1), 1024, (1500, 700, 0)),
    ("g1", (2, 1, 200, 1, 1), None, "lengths"),
    ("g4_sq4_window", (2, 4, 200, 4, 1), 64, "lengths"),
    ("g16", (2, 1, 200, 16, 1), None, "lengths"),
    ("g10_dead_rows", (3, 1, 136, 10, 1), None, "dead"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", D256_CASES, ids=[c[0] for c in D256_CASES])
def test_decode_d256_cluster_order_matches_jax(case, dtype):
    case_id, (B, Sq, Sk, Hq, Hkv), window, layout = case
    D = 256
    if isinstance(layout, tuple):
        q, k, v, q_pos, k_pos = _ring_inputs(case_id, B, Hq, Hkv, D, Sk, layout)
    else:
        q, k, v, q_pos, k_pos = _decode_inputs(case_id, B, Sq, Sk, Hq, Hkv, D, layout)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    out, lse, cluster = emulate_decode_d256(tq, tk, tv, torch.from_numpy(q_pos),
                                            torch.from_numpy(k_pos), causal=True,
                                            window=window, scale=1.0 / D ** 0.5)
    assert cluster > 1  # the merge is exercised
    qn, kn, vn = (t.float().numpy() for t in (tq, tk, tv))
    want = jops.flash_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos), causal=True,
                                window=window, impl="xla", block_q=Sq, block_k=512)
    _check((out, lse), *want, dtype)
    dead = np.isneginf(np.asarray(want[1]))
    if isinstance(layout, tuple):
        assert dead[2].all() and not dead[:2].any()
    if layout == "dead":
        assert dead[1].all() and dead[0, 0].all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_paged_d256_cluster_order_matches_pallas_interpret(dtype):
    """Kernel C's cluster order at D 256 (group 10, one KV head, page 16)
    against the Pallas paged kernel in interpret mode."""
    from test_torch_kernels import paged_case_data

    data = paged_case_data("d256_cluster", 16, (10, 1), (300, 40), D=256)
    q, k_pool, v_pool = (torch.from_numpy(np.array(x)).to(dtype) for x in data[:3])
    pos_pool, bt, q_pos = (torch.from_numpy(np.array(x)) for x in data[3:])
    out, lse, cluster = emulate_paged(q, k_pool, v_pool, pos_pool, bt, q_pos, window=None,
                                      scale=1.0 / 16, emulate=emulate_decode_d256)
    assert cluster > 1
    widened = [jnp.asarray(t.float().numpy()) for t in (q, k_pool, v_pool)]
    want = paged_decode_fwd_pallas(*widened, *data[3:], window=None, interpret=True)
    _check((out, lse), *want, dtype)


@pytest.mark.parametrize("n_keys,units,want", [
    (2048, 8, (8, 8)),  # recurrentgemma-2b's decode: B=8 x 1 KV head, 2048 slots
    (2064, 8, (9, 8)),  # its paged call: W=129 pages of 16
    (2048, 16, (8, 8)),  # B=16: 16 clusters of 8 (128 blocks)
    (2048, 200, (64, 1)),  # a large batch: one block a unit
    (20, 8, (1, 1)),  # shorter than one tile
    (0, 1, (1, 1)),  # no keys: one block of one (dead) tile
    (200, 2, (2, 4)),  # 7 tiles: the cluster at most the tile count
    (1 << 20, 8, (4096, 8)),  # no cap on the tiles of a block
])
def test_decode_rule_d256(n_keys, units, want):
    assert decode_rule_d256(n_keys, units, SM_COUNT) == want
    per, cluster = want
    n_tiles = max(1, -(-n_keys // DECODE_TILE_KEYS))
    assert (cluster - 1) * per < n_tiles <= cluster * per
    assert cluster <= DECODE_D256_MAX_CLUSTER and units * cluster <= max(SM_COUNT, units)


def test_decode_core_instance():
    """bf16 at head dim 256 takes the cluster instance; float32 at 256 and
    every other head dim the split kernel."""
    assert decode_core_instance(torch.bfloat16, 256) == "cluster"
    for dtype, D in ((torch.float32, 256), (torch.bfloat16, 128), (torch.float32, 32)):
        assert decode_core_instance(dtype, D) == "split"

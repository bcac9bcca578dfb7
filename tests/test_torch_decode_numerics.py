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
    DECODE_TILE_KEYS,
    decode_split_rule,
    decode_units,
    flash_attention_fwd_torch,
)
from repro_torch.kernels.ref import PAD_POS

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
                  sm_count=SM_COUNT):
    """Kernel C's order: the request's logical key range ``W * ps`` through
    the block table (unmapped entries are zero keys at PAD_POS, their pool
    never read), then :func:`emulate_decode` over it, causal."""
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
    return emulate_decode(q, k.to(q.dtype), v.to(q.dtype), q_pos, k_pos, causal=True,
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

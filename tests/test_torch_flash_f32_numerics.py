"""The tile walks of kernels A's, B1's and B2's CUDA-core instances,
emulated in plain torch, held against the JAX package on the same inputs.

A's CUDA-core instance (``core::flash_fwd_core_kernel`` in
``csrc/flash_fwd.cu``: float32, and bf16 at D 32, with Sq > 4) gives each
block one q-tile of :func:`core_fwd_tiling`'s rows, flags every KV tile
once (dead, wholly visible, masked element by element; a missing key counts
as padding), lists the live tiles ``CORE_FLAG_CHUNK`` at a time, and walks
them in order with the online softmax rescaled per tile.  B1's
(``core::flash_bwd_dq_core_kernel`` in ``csrc/flash_bwd.cu``) walks the
same way over :func:`core_dq_tiling`'s tiles and sums dQ tile by tile in
index order.  B2's
(``core::flash_bwd_dkv_core_kernel`` in ``csrc/flash_bwd.cu``) gives each
block one key tile, flags the q-tiles (a ragged last q-tile is masked) and
sums dK and dV over the GQA group's heads and then the live q-tiles, in
that fixed order.  :func:`emulate_core_fwd`, :func:`emulate_core_dq` and
:func:`emulate_core_dkv` repeat those walks in float32; here they are held against
``repro.kernels.ops.flash_attention(impl="xla")`` and its ``jax.vjp`` at the
limits ``chip_smoke.py`` holds the kernels to on the card (1e-4), and
every flag's skip decision against the JAX ``_tile_skip`` at the new tile
sizes.  The kernels themselves are held against the plain versions on the
card.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.zigzag import zigzag_positions
from repro.kernels import ops as jops
from repro.kernels.flash_attention import tile_skip as j_tile_skip
from repro_torch.kernels.flash_attention import (
    CORE_FLAG_CHUNK,
    core_dkv_tiling,
    core_dq_tiling,
    core_fwd_tiling,
    flash_bwd_instance,
    flash_fwd_instance,
)
from repro_torch.kernels.ref import NEG_INF, PAD_POS, visibility_mask

# chip_smoke.tolerances(torch.float32) and phase 7's float32 limit
F32 = dict(atol=1e-4, rtol=1e-4)


def tile_flag(qp, kp, *, causal: bool, window: int | None) -> int:
    """``tile_flag`` of ``csrc/common.cuh`` on one tile's real query
    positions and its key positions (missing keys as ``PAD_POS``): 0 dead,
    1 every key visible to every query, 2 masked element by element."""
    qmin, qmax, kmin, kmax = int(qp.min()), int(qp.max()), int(kp.min()), int(kp.max())
    half = PAD_POS // 2
    skip = kmin >= half or (causal and qmax < kmin) or (
        window is not None and kmax <= qmin - window)
    whole = kmax < half and (not causal or qmin >= kmax) and (
        window is None or qmax - kmin < window)
    return 0 if skip else (1 if whole else 2)


def _padded_keys(k_pos_b, k0, bk):
    kp = k_pos_b[k0:k0 + bk]
    return torch.cat([kp, torch.full((bk - kp.numel(),), PAD_POS, dtype=kp.dtype)])


def live_walk(n_tiles, flag_of):
    """The kernels' order: the live tiles of each chunk of
    ``CORE_FLAG_CHUNK`` tiles, chunk after chunk, with their flags."""
    walk = []
    for c0 in range(0, n_tiles, CORE_FLAG_CHUNK):
        for t in range(c0, min(n_tiles, c0 + CORE_FLAG_CHUNK)):
            f = flag_of(t)
            if f:
                walk.append((t, f))
    return walk


def emulate_core_fwd(q, k, v, q_pos, k_pos, *, causal: bool, window: int | None,
                     scale: float):
    """A's CUDA-core walk on ``q (B,Sq,Hq,D)``, ``k/v (B,Sk,Hkv,D)`` ->
    ``(out, lse)`` in float32; also the flags it computed, ``{(b, q-tile,
    key tile): flag}``."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    t = core_fwd_tiling(D)
    bq, bk = t["q_rows"], t["keys"]
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    out = torch.zeros((B, Sq, Hq, D), dtype=torch.float32)
    lse = torch.full((B, Sq, Hq), -torch.inf, dtype=torch.float32)
    flags = {}
    for b in range(B):
        for q0 in range(0, Sq, bq):
            rows = slice(q0, min(Sq, q0 + bq))
            qp = q_pos[b, rows]
            qb = qf[b, rows].transpose(0, 1)  # (Hq, rows, D)
            o = torch.zeros(qb.shape, dtype=torch.float32)
            m = torch.full(qb.shape[:2], NEG_INF, dtype=torch.float32)
            l = torch.zeros(qb.shape[:2], dtype=torch.float32)

            def flag_of(kt):
                f = tile_flag(qp, _padded_keys(k_pos[b], kt * bk, bk), causal=causal,
                              window=window)
                flags[(b, q0 // bq, kt)] = f
                return f

            for kt, f in live_walk(-(-Sk // bk), flag_of):
                keys = slice(kt * bk, min(Sk, (kt + 1) * bk))
                s = torch.einsum("hqd,khd->hqk", qb, kf[b, keys])
                if f == 2:
                    mask = visibility_mask(qp[None], k_pos[b, keys][None], causal=causal,
                                           window=window)
                    s = torch.where(mask, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1))
                safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
                p = torch.where(s > NEG_INF, torch.exp(s - safe[..., None]), 0.0)
                a = torch.where(m <= NEG_INF / 2, 0.0,
                                torch.exp(torch.clamp(m - safe, max=0.0)))
                l = a * l + p.sum(dim=-1)
                o = o * a[..., None] + torch.einsum("hqk,khd->hqd", p, vf[b, keys])
                m = m_new
            live = l > 0
            out[b, rows] = torch.where(live[..., None], o / torch.where(live, l, 1.0)[..., None],
                                       0.0).transpose(0, 1)
            lse[b, rows] = torch.where(live, m + torch.log(torch.where(live, l, 1.0)),
                                       -torch.inf).transpose(0, 1)
    return out.to(q.dtype), lse, flags


def emulate_core_dq(q, k, v, q_pos, k_pos, out, lse, dout, dlse, *, causal: bool,
                    window: int | None, scale: float):
    """B1's CUDA-core walk -> ``dq`` in float32, each q-tile's sum over its
    live KV tiles in index order (P and dS recomputed per tile, the mask
    only on masked tiles); also the flags it computed, ``{(b, q-tile, key
    tile): flag}``."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    t = core_dq_tiling(D)
    bq, bk = t["q_rows"], t["keys"]
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    delta = (dof * out.float()).sum(dim=-1)  # outside the kernels, as on the card
    dead = torch.isneginf(lse)
    lse0 = torch.where(dead, 0.0, lse)
    dlse0 = torch.where(dead, 0.0, dlse)
    dq = torch.zeros((B, Sq, Hq, D), dtype=torch.float32)
    flags = {}
    for b in range(B):
        for q0 in range(0, Sq, bq):
            rows = slice(q0, min(Sq, q0 + bq))
            qp = q_pos[b, rows]
            qb, dob = (x[b, rows].transpose(0, 1) for x in (qf, dof))  # (Hq, rows, D)
            lr, de, dl = (x[b, rows].T[..., None] for x in (lse0, delta, dlse0))
            acc = torch.zeros(qb.shape, dtype=torch.float32)

            def flag_of(kt):
                f = tile_flag(qp, _padded_keys(k_pos[b], kt * bk, bk), causal=causal,
                              window=window)
                flags[(b, q0 // bq, kt)] = f
                return f

            for kt, f in live_walk(-(-Sk // bk), flag_of):
                keys = slice(kt * bk, min(Sk, (kt + 1) * bk))
                s = torch.einsum("hqd,khd->hqk", qb, kf[b, keys])
                dp = torch.einsum("hqd,khd->hqk", dob, vf[b, keys])
                p = torch.exp(s * scale - lr)
                if f == 2:
                    mask = visibility_mask(qp[None], k_pos[b, keys][None], causal=causal,
                                           window=window)
                    p = torch.where(mask, p, 0.0)
                acc += torch.einsum("hqk,khd->hqd", p * (dp - de + dl) * scale, kf[b, keys])
            dq[b, rows] = acc.transpose(0, 1)
    return dq, flags


def emulate_core_dkv(q, k, v, q_pos, k_pos, out, lse, dout, dlse, *, causal: bool,
                     window: int | None, scale: float):
    """B2's CUDA-core walk -> ``(dk, dv)`` in float32, each key tile's sums
    over the group's heads and then its live q-tiles in the kernel's
    order; also the flags it computed, ``{(b, key tile, q-tile): flag}``."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    t = core_dkv_tiling(D)
    bk, bq = t["keys"], t["q_rows"]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    delta = (dof * out.float()).sum(dim=-1)  # outside the kernels, as on the card
    dead = torch.isneginf(lse)
    lse0 = torch.where(dead, 0.0, lse)
    dlse0 = torch.where(dead, 0.0, dlse)
    dk = torch.zeros((B, Sk, Hkv, D), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    flags = {}
    for b in range(B):
        for k0 in range(0, Sk, bk):
            keys = slice(k0, min(Sk, k0 + bk))
            kp = _padded_keys(k_pos[b], k0, bk)

            def flag_of(qt):
                rows = slice(qt * bq, min(Sq, (qt + 1) * bq))
                f = tile_flag(q_pos[b, rows], kp, causal=causal, window=window)
                if f == 1 and (qt + 1) * bq > Sq:
                    f = 2
                flags[(b, k0 // bk, qt)] = f
                return f

            walk = live_walk(-(-Sq // bq), flag_of)
            for hk in range(Hkv):
                acc_k = torch.zeros((keys.stop - k0, D), dtype=torch.float32)
                acc_v = torch.zeros_like(acc_k)
                for g in range(group):
                    h = hk * group + g
                    for qt, f in walk:
                        rows = slice(qt * bq, min(Sq, (qt + 1) * bq))
                        s = kf[b, keys, hk] @ qf[b, rows, h].T  # (keys, rows)
                        dp = vf[b, keys, hk] @ dof[b, rows, h].T
                        p = torch.exp(s * scale - lse0[b, rows, h][None])
                        if f == 2:
                            mask = visibility_mask(q_pos[b, rows][None], k_pos[b, keys][None],
                                                   causal=causal, window=window)[0].T
                            p = torch.where(mask, p, 0.0)
                        ds = p * (dp - delta[b, rows, h][None] + dlse0[b, rows, h][None]) * scale
                        acc_v += p @ dof[b, rows, h]
                        acc_k += ds @ qf[b, rows, h]
                dk[b, keys, hk] = acc_k
                dv[b, keys, hk] = acc_v
    return dk, dv, flags


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _positions(layout, B, Sq, Sk):
    q_pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    if layout == "zigzag":
        z = np.concatenate([np.asarray(zigzag_positions(Sq, 4, j)) for j in range(4)])
        q_pos[:] = z
        k_pos[:] = z
    elif layout == "offset":
        q_pos += 8
    elif layout == "dead":  # row 0's first 16 queries precede every key; row 1 all padding
        q_pos[0, :16] = -1
        k_pos[1] = PAD_POS
    return q_pos, k_pos


def _inputs(key, B, Sq, Sk, Hq, Hkv, D, dtype=torch.float32):
    rng = _rng(*key)
    shapes = ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, Hq, D))
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype) for s in shapes]
    dlse = torch.from_numpy(rng.standard_normal((B, Sq, Hq)).astype(np.float32))
    return (*ts, dlse)


def _skips_match_jax(flags, q_pos, k_pos, bq_q, bk_k, *, by_key, causal, window):
    """Every flag's skip decision (0) equals the JAX ``_tile_skip`` on the
    same tile's positions (real queries; keys padded with ``PAD_POS``)."""
    for (b, i, j), f in flags.items():
        qt, kt = (j, i) if by_key else (i, j)
        qp = q_pos[b, qt * bq_q:(qt + 1) * bq_q]
        kp = _padded_keys(torch.from_numpy(k_pos[b]), kt * bk_k, bk_k).numpy()
        assert (f == 0) == bool(j_tile_skip(jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                                            window=window))


def _check_fwd(key, B, Sq, Sk, Hq, Hkv, D, layout, *, causal, window):
    q, k, v, _, _ = _inputs(key, B, Sq, Sk, Hq, Hkv, D)
    q_pos, k_pos = _positions(layout, B, Sq, Sk)
    scale = 1.0 / D ** 0.5
    out, lse, flags = emulate_core_fwd(q, k, v, torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                                       causal=causal, window=window, scale=scale)
    want_out, want_lse = jops.flash_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), q_pos=jnp.asarray(q_pos),
        k_pos=jnp.asarray(k_pos), causal=causal, window=window, impl="xla")
    want_lse = np.asarray(want_lse)
    dead = np.isneginf(want_lse)
    np.testing.assert_array_equal(torch.isneginf(lse).numpy(), dead)
    assert (out.numpy()[dead] == 0).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **F32)
    np.testing.assert_allclose(lse.numpy()[~dead], want_lse[~dead], atol=1e-4, rtol=0)
    t = core_fwd_tiling(D)
    _skips_match_jax(flags, q_pos, k_pos, t["q_rows"], t["keys"], by_key=False, causal=causal,
                     window=window)
    return out, lse, flags


@functools.lru_cache(maxsize=None)
def _jax_bwd(key, B, Sq, Sk, Hq, Hkv, D, layout, causal, window):
    """The inputs of ``key``, their positions, and the JAX flash's ``(out,
    lse)`` and ``(dq, dk, dv)`` from its ``jax.vjp``, computed once for B1's
    and B2's checks on the same inputs."""
    q, k, v, dout, dlse = _inputs(key, B, Sq, Sk, Hq, Hkv, D)
    q_pos, k_pos = _positions(layout, B, Sq, Sk)

    def fwd(q, k, v):
        return jops.flash_attention(q, k, v, q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                                    causal=causal, window=window, impl="xla")

    (out, lse), vjp = jax.vjp(fwd, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    grads = vjp((jnp.asarray(dout.numpy()), jnp.asarray(dlse.numpy())))
    return ((q, k, v, dout, dlse), (q_pos, k_pos),
            tuple(torch.from_numpy(np.array(x)) for x in (out, lse, *grads)))


def _check_dq(key, B, Sq, Sk, Hq, Hkv, D, layout, *, causal, window):
    (q, k, v, dout, dlse), (q_pos, k_pos), (out, lse, want_dq, _, _) = _jax_bwd(
        key, B, Sq, Sk, Hq, Hkv, D, layout, causal, window)
    dq, flags = emulate_core_dq(q, k, v, torch.from_numpy(q_pos), torch.from_numpy(k_pos), out,
                                lse, dout, dlse, causal=causal, window=window,
                                scale=1.0 / D ** 0.5)
    assert torch.isfinite(dq).all()
    np.testing.assert_allclose(dq.numpy(), want_dq.numpy(), **F32)
    t = core_dq_tiling(D)
    _skips_match_jax(flags, q_pos, k_pos, t["q_rows"], t["keys"], by_key=False, causal=causal,
                     window=window)
    return dq, lse, flags


def _check_dkv(key, B, Sq, Sk, Hq, Hkv, D, layout, *, causal, window):
    (q, k, v, dout, dlse), (q_pos, k_pos), (out, lse, _, want_dk, want_dv) = _jax_bwd(
        key, B, Sq, Sk, Hq, Hkv, D, layout, causal, window)
    dk, dv, flags = emulate_core_dkv(
        q, k, v, torch.from_numpy(q_pos), torch.from_numpy(k_pos), out, lse, dout, dlse,
        causal=causal, window=window, scale=1.0 / D ** 0.5)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    t = core_dkv_tiling(D)
    _skips_match_jax(flags, q_pos, k_pos, t["q_rows"], t["keys"], by_key=True, causal=causal,
                     window=window)
    return dk, dv, flags


# tests/test_kernels.py::SHAPES: B, Sq, Sk, Hq, Hkv, D
SHAPES = [(1, 128, 128, 1, 1, 64), (2, 256, 256, 4, 2, 64), (1, 128, 256, 4, 1, 128),
          (1, 512, 512, 2, 2, 128)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_core_fwd_walk_on_kernel_shapes(shape, causal):
    B, Sq, Sk, Hq, Hkv, D = shape
    _check_fwd(("fwd", shape, causal), B, Sq, Sk, Hq, Hkv, D, "contig", causal=causal,
               window=None)


# tests/test_kernels.py::BWD_CASES: id, (B, S, Hq, Hkv, D), causal, layout, window
BWD_CASES = [
    ("causal", (1, 128, 2, 2, 32), True, "contig", None),
    ("noncausal", (1, 128, 2, 2, 32), False, "contig", None),
    ("gqa", (2, 128, 4, 2, 32), True, "contig", None),
    ("mqa", (1, 128, 4, 1, 64), True, "contig", None),
    ("zigzag", (1, 256, 2, 2, 32), True, "zigzag", None),
    ("zigzag_gqa", (1, 256, 4, 2, 32), True, "zigzag", None),
    ("window", (1, 256, 2, 2, 32), True, "contig", 64),
]


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_core_dkv_walk_on_kernel_cases(case):
    case_id, (B, S, Hq, Hkv, D), causal, layout, window = case
    _check_dkv(("dkv", case_id), B, S, S, Hq, Hkv, D, layout, causal=causal, window=window)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_core_dq_walk_on_kernel_shapes(shape, causal):
    B, Sq, Sk, Hq, Hkv, D = shape
    _check_dq(("dq", shape, causal), B, Sq, Sk, Hq, Hkv, D, "contig", causal=causal,
              window=None)


# B1's checks take B2's inputs (the same keys), so each case's JAX gradients
# are computed once.
@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_core_dq_walk_on_kernel_cases(case):
    case_id, (B, S, Hq, Hkv, D), causal, layout, window = case
    _check_dq(("dkv", case_id), B, S, S, Hq, Hkv, D, layout, causal=causal, window=window)


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_core_fwd_walk_on_bwd_cases(case):
    case_id, (B, S, Hq, Hkv, D), causal, layout, window = case
    _check_fwd(("fwd-bwdcase", case_id), B, S, S, Hq, Hkv, D, layout, causal=causal,
               window=window)


# The new tiles' edges at every head dim and GQA group 1, 2, 8 and 10: id,
# (B, Sq, Sk, Hq, Hkv), layout, window.  101 and 109 are multiples of no
# tile; a window of 20 is shorter than any key tile.
EDGE_CASES = [
    ("ragged", (2, 101, 109, 4, 2), "offset", None),
    ("window20", (1, 192, 192, 2, 2), "contig", 20),
    ("zigzag_g8", (1, 256, 256, 8, 1), "zigzag", None),
    ("dead_rows", (2, 160, 160, 2, 2), "dead", None),
    ("g10_window", (1, 160, 160, 10, 1), "contig", 48),
]


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_core_fwd_walk_edges(case, D):
    case_id, (B, Sq, Sk, Hq, Hkv), layout, window = case
    out, lse, flags = _check_fwd(("fwd-edge", case_id, D), B, Sq, Sk, Hq, Hkv, D, layout,
                                 causal=True, window=window)
    if layout == "dead":
        for dead in (out[0, :16], out[1]):
            assert torch.equal(dead, torch.zeros_like(dead))
        assert torch.isneginf(lse[0, :16]).all() and torch.isneginf(lse[1]).all()
        assert all(f == 0 for (b, _, _), f in flags.items() if b == 1)
    if window == 20:  # a short window leaves some tiles dead and masks the rest
        assert {0, 2} <= set(flags.values())


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_core_dkv_walk_edges(case, D):
    case_id, (B, Sq, Sk, Hq, Hkv), layout, window = case
    dk, dv, flags = _check_dkv(("dkv-edge", case_id, D), B, Sq, Sk, Hq, Hkv, D, layout,
                               causal=True, window=window)
    if layout == "dead":  # batch row 1's keys are padding: no q-tile is live
        assert torch.equal(dk[1], torch.zeros_like(dk[1]))
        assert torch.equal(dv[1], torch.zeros_like(dv[1]))
    if layout == "offset":  # the ragged last q-tile is masked, never whole
        bq = core_dkv_tiling(D)["q_rows"]
        assert all(f != 1 for (_, _, qt), f in flags.items() if (qt + 1) * bq > Sq)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_core_dq_walk_edges(case, D):
    case_id, (B, Sq, Sk, Hq, Hkv), layout, window = case
    dq, lse, flags = _check_dq(("dkv-edge", case_id, D), B, Sq, Sk, Hq, Hkv, D, layout,
                               causal=True, window=window)
    if layout == "dead":  # rows that see no key get exactly 0; batch row 1 has no live tile
        dead = torch.isneginf(lse)
        assert dead[0, :16].all() and dead[1].all()
        assert dq[dead].count_nonzero() == 0
        assert all(f == 0 for (b, _, _), f in flags.items() if b == 1)
    if window == 20:  # a short window leaves some tiles dead and masks the rest
        assert {0, 2} <= set(flags.values())


def test_core_dq_walk_lists_tiles_chunk_by_chunk():
    """More KV tiles than one chunk of flags (257 at D 32): B1's walk holds
    against JAX across the chunks' boundary, with dead tiles in the first
    chunk (left of the window, and a run of padding keys) and live tiles in
    both; its last q-tile is ragged (72 rows)."""
    D, Sq = 32, 72
    bk = core_dq_tiling(D)["keys"]
    Sk = CORE_FLAG_CHUNK * bk + bk
    rng = _rng("dq-chunks")
    q, dout = (torch.from_numpy(rng.standard_normal((1, Sq, 2, D)).astype(np.float32))
               for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, Sk, 1, D)).astype(np.float32))
            for _ in range(2))
    dlse = torch.from_numpy(rng.standard_normal((1, Sq, 2)).astype(np.float32))
    q_pos = (Sk - Sq + np.arange(Sq, dtype=np.int32))[None]
    k_pos = np.arange(Sk, dtype=np.int32)[None].copy()
    k_pos[0, 9000:9100] = PAD_POS
    window = 12000

    def fwd(q, k, v):
        return jops.flash_attention(q, k, v, q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                                    causal=True, window=window, impl="xla")

    (out, lse), vjp = jax.vjp(fwd, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want_dq = vjp((jnp.asarray(dout.numpy()), jnp.asarray(dlse.numpy())))[0]
    dq, flags = emulate_core_dq(q, k, v, torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                                torch.from_numpy(np.array(out)), torch.from_numpy(np.array(lse)),
                                dout, dlse, causal=True, window=window, scale=D ** -0.5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(want_dq), **F32)
    _skips_match_jax(flags, q_pos, k_pos, core_dq_tiling(D)["q_rows"], bk, by_key=False,
                     causal=True, window=window)
    live = {kt for (_, _, kt), f in flags.items() if f}
    assert max(live) >= CORE_FLAG_CHUNK and min(live) < CORE_FLAG_CHUNK
    assert flags[(0, 0, 9024 // bk)] == 0 and flags[(0, 0, 0)] == 0


def test_core_walks_without_keys():
    """Sk = 0: A gives every row exactly (0, -inf) without a tile, and B1
    exactly 0 for dq; B2 has no block and returns empty gradients."""
    B, Sq, Hq, Hkv, D = 1, 165, 2, 1, 32
    q = torch.from_numpy(_rng("nokeys").standard_normal((B, Sq, Hq, D)).astype(np.float32))
    k = torch.zeros((B, 0, Hkv, D))
    q_pos = torch.arange(Sq, dtype=torch.int32)[None]
    k_pos = torch.zeros((B, 0), dtype=torch.int32)
    out, lse, flags = emulate_core_fwd(q, k, k, q_pos, k_pos, causal=True, window=None,
                                       scale=D ** -0.5)
    assert flags == {}
    assert torch.equal(out, torch.zeros_like(out)) and torch.isneginf(lse).all()
    dq, flags = emulate_core_dq(q, k, k, q_pos, k_pos, out, lse, q, lse, causal=True,
                                window=None, scale=D ** -0.5)
    assert flags == {} and torch.equal(dq, torch.zeros_like(q))
    dk, dv, flags = emulate_core_dkv(q, k, k, q_pos, k_pos, out, lse, q, lse, causal=True,
                                     window=None, scale=D ** -0.5)
    assert flags == {} and dk.shape == (B, 0, Hkv, D) and dv.shape == dk.shape


def test_core_walk_lists_tiles_chunk_by_chunk():
    """More tiles than one chunk of flags: the walk visits every live tile
    once, in index order, across the chunks' boundaries."""
    n = 2 * CORE_FLAG_CHUNK + 37
    walk = live_walk(n, lambda t: 0 if t % 5 == 0 else 1 + t % 2)
    assert [t for t, _ in walk] == [t for t in range(n) if t % 5]
    assert all(f == 1 + t % 2 for t, f in walk)


def test_core_tilings_and_dispatch():
    """The tile sizes the kernels are built with (``core::Fwd``,
    ``core::Dq`` and ``core::Dkv``), and the calls that reach them: float32
    at every head dim with Sq > 4, bf16 at D 32."""
    assert [core_fwd_tiling(D)["keys"] for D in (32, 64, 128, 256)] == [64, 64, 64, 32]
    assert {core_fwd_tiling(D)["q_rows"] for D in (32, 64, 128, 256)} == {64}
    assert [tuple(core_dq_tiling(D).values()) for D in (32, 64, 128, 256)] == [
        (64, 64), (64, 64), (64, 64), (32, 32)]
    with pytest.raises(ValueError, match="head dim 48"):
        core_dq_tiling(48)
    assert [core_dkv_tiling(D)["q_rows"] for D in (32, 64, 128, 256)] == [64, 64, 64, 32]
    assert {core_dkv_tiling(D)["keys"] for D in (32, 64, 128, 256)} == {32}
    with pytest.raises(ValueError, match="head dim 48"):
        core_fwd_tiling(48)
    for D in (32, 64, 128, 256):
        assert flash_fwd_instance(torch.float32, 5, D) == "cuda_core"
        assert flash_bwd_instance(torch.float32, D) == "cuda_core"
    assert flash_fwd_instance(torch.bfloat16, 512, 32) == "cuda_core"
    assert flash_bwd_instance(torch.bfloat16, 32) == "cuda_core"
    assert flash_fwd_instance(torch.float32, 4, 128) == "decode"

"""The rounding of kernels B1 and B2's wgmma instances, emulated in plain
torch, held against the JAX package's backward on the same inputs.

The wgmma instances (``csrc/flash_bwd.cu``, bf16 with D 64/128/256) compute
the scores S = q k^T and dP = dout v^T in float32 from bf16 operands on the
tensor cores (each product exact, the sums rounded in float32), form
P = exp(S*scale - lse) and dS = P (dP - delta + dlse) scale in float32, and
round P and dS to bf16 as the A operands of the dq, dk and dv products,
which accumulate in float32: dq over 64-key tiles (B1), dk and dv over the
GQA group's heads and 64-row q-tiles in a fixed order (B2).  At D 256 each
of those sums runs over half of the gradient's columns (B1's two consumer
warpgroups, B2's two blocks a key tile), each half forming the whole-D
scores itself (:func:`wgmma_bwd_tiling`).
:func:`emulate_wgmma_bwd` repeats those roundings.  Here it is held against
``jax.vjp`` of ``repro.kernels.ops.flash_attention(impl="xla")`` on the
float32-widened bf16 inputs, with a nonzero ``dlse`` cotangent, at the limit
``chip_smoke.py`` applies to the kernels on the card (phase 7's bf16 limit):
this shows on the CPU that the design's rounding fits that limit.  The
kernels themselves are held against the plain backward on the card.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.zigzag import zigzag_positions
from repro.kernels import ops as jops
from repro_torch.kernels.flash_attention import flash_bwd_instance
from repro_torch.kernels.ref import PAD_POS, visibility_mask

# chip_smoke.BWD_BF16_LIMIT: phase 7's limit for the bf16 (wgmma) cases,
# per row of D values (|err| <= row * rms(reference row)) and per tensor
# (||err|| <= l2 * ||reference||)
BF16_GRAD = dict(row=3e-2, l2=5e-3)

# tests/test_kernels.py::BWD_CASES: id, (B, S, Hq, Hkv, D), causal, layout,
# window; D is widened to the wgmma instances' 64 and 128 below
BWD_CASES = [
    ("causal", (1, 128, 2, 2), True, "contig", None),
    ("noncausal", (1, 128, 2, 2), False, "contig", None),
    ("gqa", (2, 128, 4, 2), True, "contig", None),
    ("mqa", (1, 128, 4, 1), True, "contig", None),
    ("zigzag", (1, 256, 2, 2), True, "zigzag", None),
    ("zigzag_gqa", (1, 256, 4, 2), True, "zigzag", None),
    ("window", (1, 256, 2, 2), True, "contig", 64),
]


def wgmma_bwd_tiling(D: int) -> dict:
    """The wgmma instances' sums at head dim ``D`` (``DqSplit`` and
    ``DkvSplit`` in ``csrc/flash_bwd.cu``): B1's keys a KV tile and dQ
    columns a consumer warpgroup; B2's q rows a tile and dK/dV columns a
    block.  Up to D 128 B1's two consumers split a 128-row q-tile by rows;
    at D 256 both take the same 64-row q-tile and each half of dQ's columns,
    and two B2 blocks share a 64-key tile, each with half of dK's and dV's
    columns."""
    cols = D // 2 if D > 128 else D
    return dict(dq_keys=64, dq_cols=cols, dkv_rows=64, dkv_cols=cols)


def emulate_wgmma_bwd(q, k, v, q_pos, k_pos, out, lse, dout, dlse, *, causal: bool,
                      window: int | None, scale: float):
    """Plain-torch emulation of the wgmma instances' arithmetic on bf16
    ``q/dout (B,Sq,Hq,D)``, ``k/v (B,Sk,Hkv,D)`` with float32 ``out``,
    ``lse`` and ``dlse`` -> ``(dq, dk, dv)`` in float32.  Each gradient is
    summed per column block in the kernels' order; the q-tiles of B1 and the
    key tiles of B2 change no sum (rows and keys are independent), and a
    dead tile the kernels skip would add exact zeros."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    t = wgmma_bwd_tiling(D)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, dout))
    delta = (dof * out.float()).sum(dim=-1)  # outside the kernels, as on the card
    dead = torch.isneginf(lse)
    lse0 = torch.where(dead, 0.0, lse)
    dlse0 = torch.where(dead, 0.0, dlse)
    mask = visibility_mask(q_pos, k_pos, causal=causal, window=window)  # (B, Sq, Sk)
    dq = torch.zeros((B, Sq, Hq, D), dtype=torch.float32)
    dk = torch.zeros((B, Sk, Hkv, D), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for h in range(Hq):
        hk = h // group
        # bf16 x bf16 products are exact in float32; the sums round in float32
        s = torch.einsum("bqd,bkd->bqk", qf[:, :, h], kf[:, :, hk]) * scale
        dp = torch.einsum("bqd,bkd->bqk", dof[:, :, h], vf[:, :, hk])
        p = torch.where(mask, torch.exp(s - lse0[:, :, h, None]), 0.0)
        ds = p * (dp - delta[:, :, h, None] + dlse0[:, :, h, None]) * scale
        p16, ds16 = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
        for c0 in range(0, D, t["dq_cols"]):  # B1: a consumer's columns,
            cs = slice(c0, c0 + t["dq_cols"])
            for k0 in range(0, Sk, t["dq_keys"]):  # one KV tile after another
                ks = slice(k0, k0 + t["dq_keys"])
                dq[:, :, h, cs] += torch.einsum("bqk,bkd->bqd", ds16[:, :, ks], kf[:, ks, hk, cs])
        for c0 in range(0, D, t["dkv_cols"]):  # B2: a block's columns,
            cs = slice(c0, c0 + t["dkv_cols"])
            for q0 in range(0, Sq, t["dkv_rows"]):  # heads of the group, then q-tiles
                qs = slice(q0, q0 + t["dkv_rows"])
                dk[:, :, hk, cs] += torch.einsum("bqk,bqd->bkd", ds16[:, qs], qf[:, qs, h, cs])
                dv[:, :, hk, cs] += torch.einsum("bqk,bqd->bkd", p16[:, qs], dof[:, qs, h, cs])
    return dq, dk, dv


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _against_jax(key, B, Sq, Sk, Hq, Hkv, D, q_pos, k_pos, *, causal, window):
    """The emulation and ``jax.vjp`` of the JAX flash on the same bf16
    inputs and cotangents; raises unless every gradient is within the chip
    limit.  Returns the emulation's ``(dq, dk, dv)``."""
    rng = _rng("wgmma-bwd", *key)
    shapes = ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D), (B, Sq, Hq, D))
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     .to(torch.bfloat16) for s in shapes)
    dlse = rng.standard_normal((B, Sq, Hq)).astype(np.float32)
    qn, kn, vn, don = (x.float().numpy() for x in (q, k, v, dout))
    scale = 1.0 / D ** 0.5

    def fwd(q, k, v):
        return jops.flash_attention(q, k, v, q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                                    causal=causal, window=window, impl="xla")

    (out, lse), vjp = jax.vjp(fwd, *(jnp.asarray(x) for x in (qn, kn, vn)))
    want = vjp((jnp.asarray(don), jnp.asarray(dlse)))
    got = emulate_wgmma_bwd(q, k, v, torch.from_numpy(np.array(q_pos)),
                            torch.from_numpy(np.array(k_pos)), torch.from_numpy(np.array(out)),
                            torch.from_numpy(np.array(lse)), dout, torch.from_numpy(dlse),
                            causal=causal, window=window, scale=scale)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(g).all()
        assert_within_bf16_limit(g.numpy(), np.asarray(w), name)
    return got


def assert_within_bf16_limit(got, want, name):
    """chip_smoke.compare_grads at BWD_BF16_LIMIT: every element within
    ``row`` of its row's RMS (a row whose reference is all zero must be
    exactly zero), and the whole tensor within ``l2`` in relative norm."""
    err = np.abs(got - want)
    rms = np.sqrt(np.mean(np.square(want), axis=-1, keepdims=True))
    bad = err > BF16_GRAD["row"] * rms
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements above {BF16_GRAD['row']} of "
                           f"their row's RMS, max |err| {err.max():.3e}")
    rel_l2 = np.linalg.norm(err) / np.linalg.norm(want)
    assert rel_l2 <= BF16_GRAD["l2"], f"{name}: ||err||/||ref|| {rel_l2:.3e}"


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_wgmma_bwd_rounding_within_chip_limit(case, D):
    case_id, (B, S, Hq, Hkv), causal, layout, window = case
    pos = np.arange(S, dtype=np.int32)
    if layout == "zigzag":
        pos = np.concatenate([np.asarray(zigzag_positions(S, 4, j)) for j in range(4)])
    pos = np.broadcast_to(pos.astype(np.int32), (B, S))
    _against_jax((case_id, D), B, S, S, Hq, Hkv, D, pos, pos, causal=causal, window=window)


@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_bwd_dead_rows_exactly_zero(D):
    """Row 0's first 16 queries precede every key (causal); batch row 1's
    keys are all padding: their gradients are exactly 0."""
    B, S, Hq, Hkv = 2, 256, 2, 2
    q_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    k_pos = q_pos.copy()
    q_pos[0, :16] = -1
    k_pos[1] = PAD_POS
    dq, dk, dv = _against_jax(("dead", D), B, S, S, Hq, Hkv, D, q_pos, k_pos, causal=True,
                              window=None)
    for dead in (dq[0, :16], dq[1], dk[1], dv[1]):
        assert torch.equal(dead, torch.zeros_like(dead))


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq,Sk", [(37, 45), (165, 173)])
def test_wgmma_bwd_rounding_ragged(Sq, Sk, D):
    """Lengths that are no multiple of B1's 128-row q-tile and 64-key tile
    or of B2's 64-key tile and 64-row q-tile, with queries offset by 8
    positions."""
    B, Hq, Hkv = 2, 4, 2
    q_pos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + 8, (B, Sq))
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    _against_jax(("ragged", Sq, Sk, D), B, Sq, Sk, Hq, Hkv, D, q_pos, k_pos, causal=True,
                 window=None)


# recurrentgemma-2b's local attention (10/1 heads, D 256, causal, window),
# cut to CPU size: id, B, Sq, Sk, window, layout
D256_HEADS = (10, 1, 256)
D256_CASES = [
    ("window128_s512", 1, 512, 512, 128, "contig"),
    ("ragged_37x45", 2, 37, 45, 24, "ragged"),
    ("dead_rows", 2, 256, 256, 128, "dead"),
]


@pytest.mark.parametrize("case", D256_CASES, ids=[c[0] for c in D256_CASES])
def test_wgmma_bwd_d256_rounding_within_chip_limit(case):
    """The D-256 instances' tiling (column halves of dq, dk and dv) at 10/1
    heads, causal with a window and a nonzero dlse: within the chip limit of
    the JAX backward.  The ragged case offsets its 37 queries by 8 positions
    against 45 keys; in the dead case row 0's first 16 queries precede every
    key and batch row 1's keys are all padding, and their gradients are
    exactly 0."""
    case_id, B, Sq, Sk, window, layout = case
    Hq, Hkv, D = D256_HEADS
    q_pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    if layout == "ragged":
        q_pos += 8
    if layout == "dead":
        q_pos[0, :16] = -1
        k_pos[1] = PAD_POS
    dq, dk, dv = _against_jax(("d256", case_id), B, Sq, Sk, Hq, Hkv, D, q_pos, k_pos,
                              causal=True, window=window)
    if layout == "dead":
        for dead in (dq[0, :16], dq[1], dk[1], dv[1]):
            assert torch.equal(dead, torch.zeros_like(dead))


def test_bwd_instance_dispatch():
    """Which instance of B1/B2 takes which call (``takes_wgmma_bwd`` in the
    CUDA source): bf16 with D 64/128/256 goes to wgmma, at any length;
    float32 (D 256 included) and D = 32 stay on the CUDA-core kernels."""
    bf, f32 = torch.bfloat16, torch.float32
    assert flash_bwd_instance(bf, 128) == "wgmma"  # training
    assert flash_bwd_instance(bf, 64) == "wgmma"
    assert flash_bwd_instance(bf, 256) == "wgmma"  # recurrentgemma's training
    assert flash_bwd_instance(bf, 32) == "cuda_core"
    assert flash_bwd_instance(f32, 128) == "cuda_core"
    assert flash_bwd_instance(f32, 64) == "cuda_core"
    assert flash_bwd_instance(f32, 256) == "cuda_core"  # recurrentgemma's float32 checks

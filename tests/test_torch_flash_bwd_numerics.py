"""The rounding of kernels B1 and B2's wgmma instances, emulated in plain
torch, held against the JAX package's backward on the same inputs.

The wgmma instances (``csrc/flash_bwd.cu``, bf16 with D 64/128) compute the
scores S = q k^T and dP = dout v^T in float32 from bf16 operands on the
tensor cores (each product exact, the sums rounded in float32), form
P = exp(S*scale - lse) and dS = P (dP - delta + dlse) scale in float32, and
round P and dS to bf16 as the A operands of the dq, dk and dv products,
which accumulate in float32: dq over 64-key tiles (B1), dk and dv over the
GQA group's heads and 64-row q-tiles in a fixed order (B2).
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
DQ_KEYS = 64  # B1: keys per KV tile
DKV_ROWS = 64  # B2: q rows per tile

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


def emulate_wgmma_bwd(q, k, v, q_pos, k_pos, out, lse, dout, dlse, *, causal: bool,
                      window: int | None, scale: float):
    """Plain-torch emulation of the wgmma instances' arithmetic on bf16
    ``q/dout (B,Sq,Hq,D)``, ``k/v (B,Sk,Hkv,D)`` with float32 ``out``,
    ``lse`` and ``dlse`` -> ``(dq, dk, dv)`` in float32."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
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
        for k0 in range(0, Sk, DQ_KEYS):  # B1: one KV tile after another
            ks = slice(k0, k0 + DQ_KEYS)
            dq[:, :, h] += torch.einsum("bqk,bkd->bqd", ds16[:, :, ks], kf[:, ks, hk])
        for q0 in range(0, Sq, DKV_ROWS):  # B2: heads of the group, then q-tiles
            qs = slice(q0, q0 + DKV_ROWS)
            dk[:, :, hk] += torch.einsum("bqk,bqd->bkd", ds16[:, qs], qf[:, qs, h])
            dv[:, :, hk] += torch.einsum("bqk,bqd->bkd", p16[:, qs], dof[:, qs, h])
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


def test_bwd_instance_dispatch():
    """Which instance of B1/B2 takes which call (``takes_wgmma_bwd`` in the
    CUDA source): bf16 with D 64/128 goes to wgmma, at any length; float32
    and D = 32 stay on the CUDA-core kernels."""
    bf, f32 = torch.bfloat16, torch.float32
    assert flash_bwd_instance(bf, 128) == "wgmma"  # training
    assert flash_bwd_instance(bf, 64) == "wgmma"
    assert flash_bwd_instance(bf, 32) == "cuda_core"
    assert flash_bwd_instance(f32, 128) == "cuda_core"
    assert flash_bwd_instance(f32, 64) == "cuda_core"

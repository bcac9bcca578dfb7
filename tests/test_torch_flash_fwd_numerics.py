"""The rounding of kernel A's wgmma instance, emulated in plain torch, held
against the JAX package on the same inputs.

The wgmma instance (``csrc/flash_fwd.cu``, bf16 with D 64/128/256 and Sq >
4) computes the scores in float32 from bf16 q and k on the tensor cores,
rounds the probabilities P to bf16 for the ``P V`` product (float32
accumulate), keeps the softmax denominator from the unrounded P, and rounds
``out`` to bf16; lse stays float32.  :func:`emulate_wgmma_fwd` repeats those
roundings over the instance's key tiles (``wgmma_fwd_tiling``: 128 keys up
to D 128, 64 at D 256).  Here it is held against
``repro.kernels.ops.flash_attention(impl="xla")`` on the float32-widened
bf16 inputs, at the limits ``chip_smoke.py`` applies to the kernel on the
card (out: 5e-3 + 1e-2·|ref|, lse: 1e-3): this shows on the CPU that the
design's rounding fits those limits.  The kernel itself is held against
the plain version on the card.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.zigzag import zigzag_positions
from repro.kernels import ops as jops
from repro.kernels.ref import attention_reference as jax_reference
from repro_torch.kernels.flash_attention import flash_fwd_instance, wgmma_fwd_tiling
from repro_torch.kernels.ref import NEG_INF, PAD_POS, visibility_mask

# chip_smoke.tolerances(torch.bfloat16)
BF16_OUT = dict(atol=5e-3, rtol=1e-2)
BF16_LSE = dict(atol=1e-3, rtol=0.0)

SHAPES = [
    # B, Sq, Sk, Hq, Hkv, D  (tests/test_kernels.py::SHAPES)
    (1, 128, 128, 1, 1, 64),
    (2, 256, 256, 4, 2, 64),
    (1, 128, 256, 4, 1, 128),
    (1, 512, 512, 2, 2, 128),
]


def emulate_wgmma_fwd(q, k, v, q_pos, k_pos, *, causal: bool, window: int | None,
                      scale: float):
    """Plain-torch emulation of the wgmma instance's arithmetic on bf16
    ``q (B,Sq,Hq,D)``, ``k/v (B,Sk,Hkv,D)`` -> ``(out bf16, lse f32)``."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    bk = wgmma_fwd_tiling(D)["keys"]
    qf = q.float()
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32)
    for k0 in range(0, Sk, bk):
        kb = k[:, k0:k0 + bk].float().repeat_interleave(group, dim=2)
        vb = v[:, k0:k0 + bk].float().repeat_interleave(group, dim=2)
        # bf16 x bf16 products are exact in float32; the sums round in float32
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        mask = visibility_mask(q_pos, k_pos[:, k0:k0 + bk], causal=causal,
                               window=window)[:, None]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe_m = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(s - safe_m[..., None]), 0.0)
        alpha = torch.exp(torch.clamp(m - safe_m, max=0.0))
        alpha = torch.where(m <= NEG_INF / 2, 0.0, alpha)
        l = alpha * l + p.sum(dim=-1)  # from the unrounded P
        p16 = p.to(torch.bfloat16).float()  # P as wgmma's bf16 A operand
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p16, vb)
        m = m_new
    valid = l > 0.0
    inv = torch.where(valid, 1.0 / torch.where(valid, l, 1.0), 0.0)
    out = (acc * inv[..., None]).to(torch.bfloat16)
    lse = torch.where(valid, m + torch.log(torch.where(valid, l, 1.0)), -torch.inf)
    return out.transpose(1, 2), lse.transpose(1, 2)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _bf16_inputs(rng, q_shape, kv_shape):
    """bf16 torch tensors and their exact float32 widening as numpy."""
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
          for s in (q_shape, kv_shape, kv_shape)]
    return ts, [t.float().numpy() for t in ts]


def _check(got, want_out, want_lse):
    out, lse = got
    want_lse = np.asarray(want_lse)
    dead = np.isneginf(want_lse)
    np.testing.assert_array_equal(torch.isneginf(lse).numpy(), dead)
    out_f = out.float().numpy()
    assert (out_f[dead] == 0).all()
    np.testing.assert_allclose(out_f, np.asarray(want_out), **BF16_OUT)
    np.testing.assert_allclose(lse.numpy()[~dead], want_lse[~dead], **BF16_LSE)


def _against_jax(q_shape, kv_shape, q_pos, k_pos, key, **kw):
    (q, k, v), (qn, kn, vn) = _bf16_inputs(_rng(*key), q_shape, kv_shape)
    D = q_shape[-1]
    scale = 1.0 / D ** 0.5
    tqp = torch.from_numpy(np.array(q_pos, np.int32))
    tkp = torch.from_numpy(np.array(k_pos, np.int32))
    got = emulate_wgmma_fwd(q, k, v, tqp, tkp, scale=scale, **kw)
    want = jops.flash_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                                impl="xla", block_q=128, block_k=128, **kw)
    _check(got, *want)
    return got


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_rounding_within_chip_limits(shape, causal):
    B, Sq, Sk, Hq, Hkv, D = shape
    q_pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq))
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    _against_jax((B, Sq, Hq, D), (B, Sk, Hkv, D), q_pos, k_pos, ("wgmma", shape, causal),
                 causal=causal, window=None)


@pytest.mark.parametrize("case", ["zigzag", "dead_rows", "window"])
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_rounding_positions(case, causal):
    """Zigzag positions (P = 4), rows that see no key, and a sliding window
    of 48, at D=128 with GQA: the edge cases chip_smoke runs in bf16."""
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 128
    pos = np.arange(S, dtype=np.int32)
    q_pos = k_pos = np.broadcast_to(pos, (B, S))
    window = None
    if case == "zigzag":
        z = np.concatenate([np.asarray(zigzag_positions(S, 4, j)) for j in range(4)])
        q_pos = k_pos = np.broadcast_to(z.astype(np.int32), (B, S))
    elif case == "dead_rows":
        k_pos = np.array(k_pos)
        k_pos[1] = PAD_POS  # row 1: every key is padding
        q_pos = np.array(q_pos)
        q_pos[0, :16] = -1  # row 0: the first 16 queries precede every key (causal)
    else:
        window = 48
    out, lse = _against_jax((B, S, Hq, D), (B, S, Hkv, D), q_pos, k_pos,
                            ("wgmma-pos", case, causal), causal=causal, window=window)
    if case == "dead_rows":
        dead = [out[1]] + ([out[0, :16]] if causal else [])
        for d in dead:
            assert torch.equal(d, torch.zeros_like(d))
        assert torch.isneginf(lse[1]).all()
        assert torch.isneginf(lse[0, :16]).all() == causal


@pytest.mark.parametrize("D", [64, 128])
def test_wgmma_rounding_ragged(D):
    """Lengths that are no multiple of the 128-row q-tile or the 128-key
    tile (Sq = 37 + 128, Sk = 45 + 128), against the JAX oracle."""
    B, Sq, Sk, Hq, Hkv = 2, 165, 173, 4, 2
    (q, k, v), (qn, kn, vn) = _bf16_inputs(_rng("wgmma-ragged", D), (B, Sq, Hq, D),
                                           (B, Sk, Hkv, D))
    q_pos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + 8, (B, Sq))
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk))
    got = emulate_wgmma_fwd(q, k, v, torch.from_numpy(np.array(q_pos)),
                            torch.from_numpy(np.array(k_pos)), causal=True, window=None,
                            scale=1.0 / D ** 0.5)
    want = jax_reference(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal=True,
                         q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos))
    _check(got, *want)


# recurrentgemma-2b's local attention (10/1 heads, D 256, causal, window),
# cut to CPU size: id, B, Sq, Sk, window, layout
D256_HEADS = (10, 1, 256)
D256_CASES = [
    ("window128_s512", 1, 512, 512, 128, "contig"),
    ("ragged_37x45", 2, 37, 45, 24, "ragged"),
    ("dead_rows", 2, 256, 256, 128, "dead"),
]


@pytest.mark.parametrize("case", D256_CASES, ids=[c[0] for c in D256_CASES])
def test_wgmma_fwd_d256_rounding_within_chip_limit(case):
    """The D-256 tiling (64-key tiles; 64-row q-tiles whose two consumers
    each hold half of O's columns, which changes no sum) at 10/1 heads,
    causal with a window: within the chip limits of the JAX forward.  The
    ragged case offsets its 37 queries by 8 positions against 45 keys (one
    partial key tile); in the dead case row 0's first 16 queries precede
    every key and batch row 1's keys are all padding, and their out is
    exactly 0 and their lse -inf."""
    case_id, B, Sq, Sk, window, layout = case
    Hq, Hkv, D = D256_HEADS
    assert wgmma_fwd_tiling(D)["keys"] == 64
    q_pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    k_pos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    if layout == "ragged":
        q_pos += 8
    if layout == "dead":
        q_pos[0, :16] = -1
        k_pos[1] = PAD_POS
    (q, k, v), (qn, kn, vn) = _bf16_inputs(_rng("wgmma-d256", case_id), (B, Sq, Hq, D),
                                           (B, Sk, Hkv, D))
    got = emulate_wgmma_fwd(q, k, v, torch.from_numpy(q_pos), torch.from_numpy(k_pos),
                            causal=True, window=window, scale=1.0 / D ** 0.5)
    want = jops.flash_attention(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos),
                                causal=True, window=window, impl="xla")
    _check(got, *want)
    if layout == "dead":
        out, lse = got
        for dead in (out[0, :16], out[1]):
            assert torch.equal(dead, torch.zeros_like(dead))
        assert torch.isneginf(lse[0, :16]).all() and torch.isneginf(lse[1]).all()


def test_instance_dispatch():
    """Which instance of kernel A takes which call (``takes_decode`` and
    ``takes_wgmma`` in the CUDA source): bf16 prefill and training calls go
    to wgmma (D 256 included: recurrentgemma's); the dense decode (Sq <= 4)
    to the decode instance; float32 (D 256 included) and D = 32 with Sq > 4
    stay on the CUDA-core kernel."""
    bf, f32 = torch.bfloat16, torch.float32
    assert flash_fwd_instance(bf, 4096, 128) == "wgmma"  # training
    assert flash_fwd_instance(bf, 256, 128) == "wgmma"  # prefill
    assert flash_fwd_instance(bf, 5, 64) == "wgmma"
    assert flash_fwd_instance(bf, 4096, 256) == "wgmma"  # recurrentgemma's training
    assert flash_fwd_instance(bf, 5, 256) == "wgmma"
    assert flash_fwd_instance(bf, 4, 128) == "decode"  # dense decode
    assert flash_fwd_instance(bf, 1, 128) == "decode"
    assert flash_fwd_instance(bf, 4, 256) == "decode"  # recurrentgemma's decode
    assert flash_fwd_instance(bf, 1, 256) == "decode"
    assert flash_fwd_instance(bf, 256, 32) == "cuda_core"
    assert flash_fwd_instance(f32, 4096, 128) == "cuda_core"
    assert flash_fwd_instance(f32, 4096, 256) == "cuda_core"  # recurrentgemma's float32 checks
    assert [wgmma_fwd_tiling(D)["keys"] for D in (64, 128, 256)] == [128, 128, 64]
    assert wgmma_fwd_tiling(256) == dict(q_rows=64, keys=64, o_cols=128)
    with pytest.raises(ValueError, match="no wgmma instance at head dim 32"):
        wgmma_fwd_tiling(32)

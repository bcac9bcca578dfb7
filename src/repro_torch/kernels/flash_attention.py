"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.flash_attention`` (forward only; the
backward kernels come with the training slice).

* :func:`flash_attention_fwd_cuda` launches kernel A,
  ``csrc/flash_fwd.cu``, which replaces the Pallas TPU kernel
  ``repro.kernels.flash_attention.flash_attention_fwd_pallas``.  It is
  bound on this card by shared-memory traffic of its float32 CUDA-core
  products (see the source note in the ``.cu`` file); its design keeps the
  online-softmax state on chip and skips dead KV tiles whole.
* :func:`flash_attention_fwd_torch` is the plain version: a loop over KV
  blocks with the same online-softmax update, used for CPU tensors and as
  the kernel's yardstick on the card.

Both return the TokenRing partial ``(out, lse)``; rows that see no key give
``out = 0, lse = -inf``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import NEG_INF, PAD_POS, visibility_mask

__all__ = [
    "flash_attention_fwd_cuda",
    "flash_attention_fwd_torch",
    "tile_skip",
    "tile_mask",
    "check_kernel_args",
]


def tile_skip(q_pos, k_pos, *, causal: bool, window: int | None) -> bool:
    """Whether a (q-tile, kv-tile) block is provably all-masked (the Pallas
    ``_tile_skip``): every key is padding, causally after every query, or
    left of every query's window.  1-D position tiles."""
    k_min = int(k_pos.min())
    skip = k_min >= PAD_POS // 2
    if causal:
        skip = skip or int(q_pos.max()) < k_min
    if window is not None:
        skip = skip or int(k_pos.max()) <= int(q_pos.min()) - window
    return skip


def tile_mask(q_pos, k_pos, *, causal: bool, window: int | None):
    """``(bq, bk)`` visibility mask of one score tile (padding/causal/window)."""
    return visibility_mask(q_pos[None], k_pos[None], causal=causal, window=window)[0]


def flash_attention_fwd_torch(q, k, v, q_pos, k_pos, *, causal: bool, window: int | None,
                              scale: float, block_k: int):
    """Plain blockwise flash forward (port of ``ops._xla_flash_fwd``).

    ``q_pos (B,Sq)`` / ``k_pos (B,Sk)`` int32; ``Sk % block_k == 0``.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qf = q.float() * scale
    acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, block_k):
        kb = k[:, k0:k0 + block_k].float().repeat_interleave(group, dim=2)
        vb = v[:, k0:k0 + block_k].float().repeat_interleave(group, dim=2)
        kp = k_pos[:, k0:k0 + block_k]
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        mask = visibility_mask(q_pos, kp, causal=causal, window=window)[:, None]
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        safe_m = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.where(mask, torch.exp(scores - safe_m[..., None]), 0.0)
        alpha = torch.exp(torch.clamp(m - safe_m, max=0.0))
        alpha = torch.where(m <= NEG_INF / 2, 0.0, alpha)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    valid = l > 0.0
    denom = torch.where(valid, l, 1.0)
    out = torch.where(valid[..., None], acc / denom[..., None], 0.0)
    lse = torch.where(valid, m + torch.log(denom), -torch.inf)
    return out.transpose(1, 2).to(q.dtype), lse.transpose(1, 2)


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = {"flash_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_void_p]}


def check_kernel_args(name: str, device, dtype, D: int, ints=(), floats=()):
    """The checks every kernel wrapper runs before handing pointers to C:
    one CUDA device, a supported dtype and head dim, contiguous tensors."""
    for t in (*floats, *ints):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: every tensor must be on {device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in floats:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} vs {dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: index tensors must be int32, got {t.dtype}")
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    if D not in (32, 64, 128):
        raise ValueError(f"{name}: head dim {D} not supported (32, 64, 128)")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def flash_attention_fwd_cuda(q, k, v, q_pos, k_pos, *, causal: bool, window: int | None,
                             scale: float):
    """Launch kernel A (``csrc/flash_fwd.cu``) -> ``(out, lse)``.

    ``q (B,Sq,Hq,D)``, ``k/v (B,Sk,Hkv,D)`` float32 or bfloat16 on one CUDA
    device, ``q_pos (B,Sq)`` / ``k_pos (B,Sk)`` int32, all contiguous.
    Raises on anything else; never falls back.
    """
    from repro_torch.kernels._build import load_library

    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    check_kernel_args("flash_attention_fwd_cuda", q.device, q.dtype, D,
                      ints=(q_pos, k_pos), floats=(q, k, v))
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"flash_attention_fwd_cuda: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q_pos.shape != (B, Sq) or k_pos.shape != (B, Sk):
        raise ValueError("flash_attention_fwd_cuda: positions must be (B,Sq)/(B,Sk)")
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    err = load_library("flash_fwd", _ARGTYPES).flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, Sq, Sk, Hq, Hkv, D,
        _KERNEL_DTYPES[q.dtype], int(causal), int(window is not None),
        int(window or 0), float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_fwd_cuda")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0

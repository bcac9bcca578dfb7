"""Fused paged-decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.paged_attention``.

* :func:`paged_decode_fwd_cuda` launches kernel C, ``csrc/paged_decode.cu``,
  which replaces the Pallas TPU kernel
  ``repro.kernels.paged_attention.paged_decode_fwd_pallas``.  It reads the
  page pool in place through the block table (no gathered view).  Its bound
  on this card is the bytes of the mapped pages over the memory rate.  It is
  the paged instance of the split-KV decode core ``csrc/decode.cuh``, shared
  with kernel A's decode instance: the request's logical key range is split
  over blocks by :func:`~repro_torch.kernels.flash_attention.decode_split_rule`
  (from the SM count and the table width), 32-key tiles stream through a
  cp.async ring, and the last block of each (KV head, batch row) merges the
  splits in split order; see the source note in ``decode.cuh``.  One wrapper
  call (one count in ``launches``) is one launch of the device kernel
  ``rt::dec::decode_kernel<..., true>``.
* :func:`paged_decode_fwd_torch` is the plain version: gather the
  block-table view (``serving.kv_cache``) and run the plain flash forward
  over it, exactly the JAX ``impl="xla"`` oracle.

:func:`page_skip` / :func:`page_mask` are the kernel's predicates, kept in
Python for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import (
    _KERNEL_DTYPES,
    _ptr,
    _raise_on,
    check_kernel_args,
    decode_scratch,
    flash_attention_fwd_torch,
)
from repro_torch.kernels.ref import PAD_POS

__all__ = ["paged_decode_fwd_cuda", "paged_decode_fwd_torch", "page_skip", "page_mask"]

_ARGTYPES = {"paged_decode": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}


def page_skip(entry: int, k_pos, q_pos: int, *, n_pages: int, window: int | None = None) -> bool:
    """Whether one block-table step is dead: the raw entry is unmapped, or
    every slot of the page is padding, causally after the query, or out of
    its window.  Liveness comes from the entry first, never from the
    (possibly aliased) page contents."""
    if entry >= n_pages or entry < 0:
        return True
    k_min = int(k_pos.min())
    skip = k_min >= PAD_POS // 2 or q_pos < k_min
    if window is not None:
        skip = skip or int(k_pos.max()) <= q_pos - window
    return skip


def page_mask(k_pos, q_pos: int, *, window: int | None = None):
    """Per-slot visibility within one page: padding, causal, window."""
    mask = (k_pos < PAD_POS // 2) & (q_pos >= k_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    return mask


def paged_decode_fwd_torch(q, k_pool, v_pool, pos_pool, block_tables, q_pos, *,
                           lengths=None, window: int | None, scale: float, block_k: int):
    """Gather the (lengths-clamped) block-table view and run the plain flash."""
    from repro_torch.kernels.ops import pick_block
    from repro_torch.serving.kv_cache import gather_pages, gather_positions, view_indices

    flat_view = view_indices(block_tables, k_pool.shape[1], lengths=lengths)
    k_view = gather_pages(k_pool, flat_view)
    v_view = gather_pages(v_pool, flat_view)
    pos_view = gather_positions(pos_pool, flat_view)
    return flash_attention_fwd_torch(
        q, k_view, v_view, q_pos, pos_view, causal=True, window=window, scale=scale,
        block_k=pick_block(k_view.shape[1], block_k),
    )


def paged_decode_fwd_cuda(q, k_pool, v_pool, pos_pool, block_tables, q_pos, *,
                          window: int | None, scale: float):
    """Launch kernel C (``csrc/paged_decode.cu``) -> ``(out, lse)``.

    ``q (B,1,Hq,D)``, pools ``(n_pages,ps,Hkv,D)`` float32 or bfloat16,
    ``pos_pool (n_pages,ps)``, ``block_tables (B,W)``, ``q_pos (B,1)`` int32,
    all contiguous on one CUDA device.  Raises on anything else.
    """
    from repro_torch.kernels._build import load_library

    B, Sq, Hq, D = q.shape
    n_pages, ps, Hkv, _ = k_pool.shape
    W = block_tables.shape[1]
    name = "paged_decode_fwd_cuda"
    check_kernel_args(name, q.device, q.dtype, D,
                      ints=(pos_pool, block_tables, q_pos), floats=(q, k_pool, v_pool))
    if Sq != 1 or k_pool.shape[3] != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} pool{tuple(k_pool.shape)}")
    if Hq % Hkv:
        raise ValueError(f"{name}: {Hq} query heads do not split over {Hkv} KV heads")
    if pos_pool.shape != (n_pages, ps) or block_tables.shape[0] != B or q_pos.shape != (B, 1):
        raise ValueError(f"{name}: bad pos_pool/block_tables/q_pos shapes")
    for t in (k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: pools must be 16-byte aligned for 16-byte copies")
    out = torch.empty_like(q)
    lse = torch.empty((B, 1, Hq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    per, part_out, part_lse, counters = decode_scratch(q.device, B, 1, Hq, Hkv, D, W * ps)
    err = load_library("paged_decode", _ARGTYPES).paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pos_pool.data_ptr(),
        block_tables.data_ptr(), q_pos.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _ptr(part_out), _ptr(part_lse), _ptr(counters), B, n_pages, ps, Hq, Hkv, W, D,
        _KERNEL_DTYPES[q.dtype], int(window is not None), int(window or 0), float(scale),
        per, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, name)
    paged_decode_fwd_cuda.launches += 1
    return out, lse


paged_decode_fwd_cuda.launches = 0

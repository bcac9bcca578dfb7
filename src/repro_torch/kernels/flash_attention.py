"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.flash_attention``.

* :func:`flash_attention_fwd_cuda` launches kernel A,
  ``csrc/flash_fwd.cu``, which replaces the Pallas TPU kernel
  ``repro.kernels.flash_attention.flash_attention_fwd_pallas``.  It has three
  instances behind one C entry (:func:`flash_fwd_instance` says which takes
  a call): the dense decode (every call with Sq <= 4) runs on the split-KV
  decode core ``csrc/decode.cuh`` shared with kernel C (the KV range split
  over blocks by :func:`decode_split_rule`, cp.async-fed tiles, scores and
  P V in registers, the splits merged in a fixed order by the last block),
  bound by the bytes of the live keys; bf16 calls with D 64/128 and Sq > 4
  (training, serving prefill) run on the tensor cores, with TMA-fed K/V
  tiles, ``wgmma`` products and the online softmax in registers, and are
  bound by the tensor-core rate; float32 and D = 32 calls with Sq > 4 run
  on the CUDA cores, bound by shared-memory traffic.  All skip dead KV
  tiles whole (see the source notes in the ``.cu`` files).
* :func:`flash_attention_fwd_torch` is the plain version: a loop over KV
  blocks with the same online-softmax update, used for CPU tensors and as
  the kernel's yardstick on the card.
* :func:`flash_attention_bwd_dq_cuda` and :func:`flash_attention_bwd_dkv_cuda`
  launch kernels B1 and B2, ``csrc/flash_bwd.cu``, which replace the two
  Pallas kernels of ``flash_attention_bwd_pallas`` (``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``).  Each has two instances behind its C entry
  (:func:`flash_bwd_instance` says which takes a call): bf16 calls with D
  64/128 run on the tensor cores (TMA-fed tiles, ``wgmma`` products, P and
  dS rounded to bf16 as operands), float32 calls and D = 32 on the CUDA
  cores.  Both use kernel A's tile skip; B2 sums the GQA group inside one
  block, without atomics, so gradients are bitwise reproducible.
* :func:`flash_attention_bwd_torch` is their plain version, a port of
  ``ops._xla_flash_bwd``: the same recompute, ``+ dlse`` term and skip
  predicate.

The forward returns the TokenRing partial ``(out, lse)``; rows that see no
key give ``out = 0, lse = -inf`` and, in the backward, exactly zero
gradients.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import NEG_INF, PAD_POS, visibility_mask

__all__ = [
    "flash_attention_fwd_cuda",
    "flash_attention_fwd_torch",
    "flash_fwd_instance",
    "flash_fwd_smem_bytes",
    "decode_split_rule",
    "decode_scratch",
    "flash_attention_bwd_dq_cuda",
    "flash_attention_bwd_dkv_cuda",
    "flash_attention_bwd_torch",
    "flash_bwd_instance",
    "tile_skip",
    "tile_skip_grid",
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


def tile_skip_grid(q_pos, k_pos, bq: int, bk: int, *, causal: bool, window: int | None):
    """Per-(batch, q-tile, kv-tile) dead-tile predicate, ``(B, nq, nk)`` bool:
    the vectorized :func:`tile_skip` (port of ``ops._tile_skip_grid``)."""
    B, Sq = q_pos.shape
    Sk = k_pos.shape[1]
    nq, nk = Sq // bq, Sk // bk
    qp = q_pos.reshape(B, nq, bq)
    kp = k_pos.reshape(B, nk, bk)
    q_max = qp.amax(dim=-1)
    k_min = kp.amin(dim=-1)
    skip = (k_min >= PAD_POS // 2)[:, None, :].expand(B, nq, nk)
    if causal:
        skip = skip | (q_max[:, :, None] < k_min[:, None, :])
    if window is not None:
        q_min = qp.amin(dim=-1)
        k_max = kp.amax(dim=-1)
        skip = skip | (k_max[:, None, :] <= q_min[:, :, None] - window)
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


def flash_attention_bwd_torch(q, k, v, q_pos, k_pos, out, lse, dout, dlse, *, causal: bool,
                              window: int | None, scale: float, block_q: int, block_k: int):
    """Plain blockwise flash backward (port of ``ops._xla_flash_bwd``)
    -> ``(dq, dk, dv)`` in float32.

    Same recompute as kernels B1/B2: ``p = exp(s - lse)``, ``ds = p * (dp -
    delta + dlse) * scale`` with ``delta = rowsum(dout * out)``; rows whose
    lse is ``-inf`` take lse and dlse as 0.  A (q-tile, kv-tile) pair is
    skipped when it is dead for every batch row.  ``dlse=None`` is zero.
    ``Sq % block_q == 0`` and ``Sk % block_k == 0``.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    bq, bk = block_q, block_k
    nq, nk = Sq // bq, Sk // bk
    qf = q.float()
    doutf = dout.float()
    delta = (doutf * out.float()).sum(dim=-1)
    row_valid = ~torch.isneginf(lse)
    dlse = torch.zeros_like(lse) if dlse is None else dlse.float()
    dlse = torch.where(row_valid, dlse, 0.0)
    lse_safe = torch.where(row_valid, lse, 0.0)
    # (B,Sq,Hq) -> (B,Hq,Sq): the score tiles' layout
    lse_t, delta_t, dlse_t = (x.transpose(1, 2) for x in (lse_safe, delta, dlse))
    skip = tile_skip_grid(q_pos, k_pos, bq, bk, causal=causal, window=window).all(dim=0)

    dq = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, Hkv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for ik in range(nk):
        ks = slice(ik * bk, (ik + 1) * bk)
        kb = k[:, ks].float().repeat_interleave(group, dim=2)
        vb = v[:, ks].float().repeat_interleave(group, dim=2)
        kp = k_pos[:, ks]
        for iq in range(nq):
            if bool(skip[iq, ik]):
                continue
            qs = slice(iq * bq, (iq + 1) * bq)
            qb, dob = qf[:, qs], doutf[:, qs]
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
            mask = visibility_mask(q_pos[:, qs], kp, causal=causal, window=window)[:, None]
            s = torch.where(mask, s, NEG_INF)
            p = torch.where(mask, torch.exp(s - lse_t[:, :, qs, None]), 0.0)
            dp = torch.einsum("bqhd,bkhd->bhqk", dob, vb)
            ds = p * (dp - delta_t[:, :, qs, None] + dlse_t[:, :, qs, None]) * scale
            dq[:, qs] += torch.einsum("bhqk,bkhd->bqhd", ds, kb)
            dk_t = torch.einsum("bhqk,bqhd->bkhd", ds, qb)
            dv_t = torch.einsum("bhqk,bqhd->bkhd", p, dob)
            dk[:, ks] += dk_t.reshape(B, bk, Hkv, group, D).sum(dim=3)
            dv[:, ks] += dv_t.reshape(B, bk, Hkv, group, D).sum(dim=3)
    return dq, dk, dv


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = {"flash_fwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
             "flash_fwd_wgmma_smem": [ctypes.c_int] * 2}
_BWD_ARGTYPES = {
    "flash_bwd_dq": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                    ctypes.c_void_p],
    "flash_bwd_dkv": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                     ctypes.c_void_p],
    "flash_bwd_takes_wgmma": [ctypes.c_int] * 2,
}


def check_kernel_args(name: str, device, dtype, D: int, ints=(), floats=()):
    """The checks every kernel wrapper runs before handing pointers to C:
    one CUDA device, a supported dtype and head dim, contiguous tensors."""
    for t in (*floats, *ints):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: every tensor must be on one CUDA device ({device}), "
                             f"got {t.device}")
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


def flash_fwd_instance(dtype, Sq: int, D: int) -> str:
    """Which instance of kernel A takes a call: ``"decode"`` (every call with
    ``Sq <= 4``), ``"wgmma"`` (bf16, ``D`` 64 or 128, ``Sq > 4``) or
    ``"cuda_core"`` (the rest: float32 and ``D = 32`` with ``Sq > 4``).
    Mirrors ``takes_decode`` and ``takes_wgmma`` in ``csrc/flash_fwd.cu``."""
    if Sq <= DECODE_MAX_SQ:
        return "decode"
    if dtype == torch.bfloat16 and D in (64, 128):
        return "wgmma"
    return "cuda_core"


# The split-KV decode core (csrc/decode.cuh), shared by kernel A's decode
# instance and kernel C.
DECODE_MAX_SQ = 4  # query rows per batch row that A's decode instance takes
DECODE_TILE_KEYS = 32  # keys per KV tile (csrc kTK)
DECODE_MAX_ROWS = 64  # query rows (group x Sq) one block holds (csrc kMaxRows)
DECODE_MAX_SPLIT_TILES = 64  # tiles of one split at most (csrc kMaxSplitTiles)
DECODE_BLOCKS_PER_SM = 4  # blocks the split rule aims for on each SM


def decode_split_rule(n_keys: int, units: int, sm_count: int) -> tuple[int, int]:
    """``(tiles_per_split, splits)`` of a decode call over ``n_keys`` keys
    (dense ``Sk``; paged ``W * page_size``) with ``units`` blocks per split
    (batch rows x KV heads x row chunks) on a card of ``sm_count`` SMs: about
    ``DECODE_BLOCKS_PER_SM`` blocks per SM, each split at least one 32-key
    tile and at most ``DECODE_MAX_SPLIT_TILES``.  The kernels take
    ``tiles_per_split`` and derive ``splits = ceil(tiles / tiles_per_split)``
    the same way."""
    n_tiles = max(1, -(-n_keys // DECODE_TILE_KEYS))
    want = max(1, -(-DECODE_BLOCKS_PER_SM * sm_count // units))
    per = min(-(-n_tiles // min(n_tiles, want)), DECODE_MAX_SPLIT_TILES)
    return per, -(-n_tiles // per)


def decode_units(B: int, Hq: int, Hkv: int, Sq: int) -> int:
    """Blocks of one split: batch rows x KV heads x chunks of
    ``DECODE_MAX_ROWS`` query rows (the GQA group x Sq)."""
    return B * Hkv * -(-(Hq // Hkv) * Sq // DECODE_MAX_ROWS)


_SM_COUNT: dict[int, int] = {}
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def decode_scratch(device, B: int, Sq: int, Hq: int, Hkv: int, D: int, n_keys: int):
    """What a decode launch needs besides its inputs: ``tiles_per_split``
    and the float32 partials ``(part_out, part_lse)`` plus the int32 merge
    counters, or three ``None`` when one split covers the range.  The
    counters are zero at rest and every launch leaves them zero; launches on
    one stream run one after another, so one buffer per (device, current
    stream) serves every call, and launches on two streams at once never
    share one."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    units = decode_units(B, Hq, Hkv, Sq)
    per, splits = decode_split_rule(n_keys, units, _SM_COUNT[idx])
    if splits == 1:
        return per, None, None, None
    rows = B * Sq * Hq
    key = (idx, torch.cuda.current_stream(idx).stream_id)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < units:
        counters = _COUNTERS[key] = torch.zeros(units, dtype=torch.int32, device=device)
    part_out = torch.empty((splits, rows, D), dtype=torch.float32, device=device)
    part_lse = torch.empty((splits, rows), dtype=torch.float32, device=device)
    return per, part_out, part_lse, counters


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def flash_fwd_smem_bytes(D: int, Sk: int) -> int:
    """Dynamic shared memory of one block of the wgmma instance (builds the
    library on first use; needs the CUDA toolchain)."""
    from repro_torch.kernels._build import load_library

    return load_library("flash_fwd", _ARGTYPES).flash_fwd_wgmma_smem(D, Sk)


def flash_bwd_instance(dtype, D: int) -> str:
    """Which instance of kernels B1 and B2 takes a call: ``"wgmma"`` (bf16,
    ``D`` 64 or 128) or ``"cuda_core"`` (float32, ``D = 32``).  Mirrors
    ``takes_wgmma_bwd`` in ``csrc/flash_bwd.cu``."""
    if dtype == torch.bfloat16 and D in (64, 128):
        return "wgmma"
    return "cuda_core"


def flash_bwd_instance_built(dtype, D: int) -> str:
    """:func:`flash_bwd_instance` as the built library decides it (builds the
    library on first use; needs the CUDA toolchain)."""
    from repro_torch.kernels._build import load_library

    lib = load_library("flash_bwd", _BWD_ARGTYPES)
    return "wgmma" if lib.flash_bwd_takes_wgmma(int(dtype == torch.bfloat16), D) else "cuda_core"


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
    per, part_out, part_lse, counters = 1, None, None, None
    if flash_fwd_instance(q.dtype, Sq, D) == "decode":
        for t in (k, v):
            if t.data_ptr() % 16:
                raise ValueError("flash_attention_fwd_cuda: k/v must be 16-byte aligned")
        per, part_out, part_lse, counters = decode_scratch(q.device, B, Sq, Hq, Hkv, D, Sk)
    err = load_library("flash_fwd", _ARGTYPES).flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _ptr(part_out), _ptr(part_lse), _ptr(counters),
        B, Sq, Sk, Hq, Hkv, D, _KERNEL_DTYPES[q.dtype], int(causal), int(window is not None),
        int(window or 0), float(scale), per, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_fwd_cuda")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0


def _check_bwd_args(name, q, k, v, q_pos, k_pos, dout, lse, delta, dlse):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    check_kernel_args(name, q.device, q.dtype, D, ints=(q_pos, k_pos),
                      floats=(q, k, v, dout))
    if k.shape != (B, Sk, Hkv, D) or v.shape != k.shape or dout.shape != q.shape or Hq % Hkv:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} dout{tuple(dout.shape)}")
    if q_pos.shape != (B, Sq) or k_pos.shape != (B, Sk):
        raise ValueError(f"{name}: positions must be (B,Sq)/(B,Sk)")
    for t in (lse, delta, dlse):
        if t.dtype != torch.float32 or t.shape != (B, Sq, Hq):
            raise ValueError(f"{name}: lse/delta/dlse must be float32 (B,Sq,Hq)")
    check_kernel_args(name, q.device, torch.float32, D, floats=(lse, delta, dlse))


def _bwd_scalars(q, k, causal, window, scale):
    B, Sq, Hq, D = q.shape
    return (B, Sq, k.shape[1], Hq, k.shape[2], D, _KERNEL_DTYPES[q.dtype], int(causal),
            int(window is not None), int(window or 0), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_bwd_dq_cuda(q, k, v, q_pos, k_pos, dout, lse, delta, dlse, *,
                                causal: bool, window: int | None, scale: float):
    """Launch kernel B1 (``csrc/flash_bwd.cu``) -> ``dq (B,Sq,Hq,D)`` float32.

    ``q/dout (B,Sq,Hq,D)``, ``k/v (B,Sk,Hkv,D)`` float32 or bfloat16,
    ``lse``/``delta = rowsum(dout*out)``/``dlse`` ``(B,Sq,Hq)`` float32,
    positions int32, all contiguous on one CUDA device.  Raises on anything
    else; never falls back.
    """
    from repro_torch.kernels._build import load_library

    name = "flash_attention_bwd_dq_cuda"
    _check_bwd_args(name, q, k, v, q_pos, k_pos, dout, lse, delta, dlse)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if dq.numel() == 0:
        return dq
    err = load_library("flash_bwd", _BWD_ARGTYPES).flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dlse.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), dq.data_ptr(),
        *_bwd_scalars(q, k, causal, window, scale))
    _raise_on(err, name)
    flash_attention_bwd_dq_cuda.launches += 1
    return dq


def flash_attention_bwd_dkv_cuda(q, k, v, q_pos, k_pos, dout, lse, delta, dlse, *,
                                 causal: bool, window: int | None, scale: float):
    """Launch kernel B2 (``csrc/flash_bwd.cu``) -> ``(dk, dv)``, each
    ``(B,Sk,Hkv,D)`` float32.  Same arguments and checks as
    :func:`flash_attention_bwd_dq_cuda`."""
    from repro_torch.kernels._build import load_library

    name = "flash_attention_bwd_dkv_cuda"
    _check_bwd_args(name, q, k, v, q_pos, k_pos, dout, lse, delta, dlse)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    if dk.numel() == 0:
        return dk, dv
    err = load_library("flash_bwd", _BWD_ARGTYPES).flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dlse.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_bwd_scalars(q, k, causal, window, scale))
    _raise_on(err, name)
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dkv_cuda.launches = 0

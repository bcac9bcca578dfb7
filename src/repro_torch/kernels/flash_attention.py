"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.flash_attention``.

* :func:`flash_attention_fwd_cuda` launches kernel A,
  ``csrc/flash_fwd.cu``, which replaces the Pallas TPU kernel
  ``repro.kernels.flash_attention.flash_attention_fwd_pallas``.  It has three
  instances behind one C entry (:func:`flash_fwd_instance` says which takes
  a call): the dense decode (every call with Sq <= 4) runs on the decode
  core shared with kernel C, bound by the bytes of the live keys
  (:func:`decode_core_instance` says which kernel): the split-KV kernel of
  ``csrc/decode.cuh`` (the KV range split over blocks by
  :func:`decode_split_rule`, cp.async-fed tiles, scores and P V in
  registers, the splits merged in a fixed order by the last block), or at
  bf16 D 256 the cluster instance of ``csrc/decode_d256.cuh`` (one wave of
  TMA-fed blocks split by :func:`decode_rule_d256`, ``mma.sync`` products,
  the blocks of a unit merged through a thread-block cluster's shared
  memory); bf16 calls with D 64, 128 or 256
  and Sq > 4 (training, serving prefill; at D 256 recurrentgemma's local
  attention, split by O's columns: :func:`wgmma_fwd_tiling`) run on the tensor
  cores, with TMA-fed K/V tiles, ``wgmma`` products and the online softmax
  in registers, and are bound by the tensor-core rate; float32 and D = 32
  calls with Sq > 4 run on the CUDA cores in exact float32 (register-tiled
  FFMA products, a cp.async ring, the softmax in registers:
  :func:`core_fwd_tiling`), bound by the FP32 rate.
  Head dims
  32, 64, 128 and 256 (``FLASH_DIMS``); the decode core's D-256 instances
  take 1 to 16 rows a KV head (:func:`check_decode_rows`).  All skip dead
  KV tiles whole (see the source notes in the ``.cu`` files).
* :func:`flash_attention_fwd_torch` is the plain version: a loop over KV
  blocks with the same online-softmax update, used for CPU tensors and as
  the kernel's yardstick on the card.
* :func:`flash_attention_bwd_dq_cuda` and :func:`flash_attention_bwd_dkv_cuda`
  launch kernels B1 and B2, ``csrc/flash_bwd.cu``, which replace the two
  Pallas kernels of ``flash_attention_bwd_pallas`` (``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``).  Each has two instances behind its C entry
  (:func:`flash_bwd_instance` says which takes a call): bf16 calls with D
  64, 128 or 256 (recurrentgemma's local attention; there the block's work
  is split by dQ's, dK's and dV's columns) run on the tensor cores (TMA-fed
  tiles, ``wgmma`` products, P and dS rounded to bf16 as operands), float32
  calls and D = 32 on the CUDA cores (register-tiled like A's:
  :func:`core_dq_tiling`, :func:`core_dkv_tiling`).  Both use kernel
  A's tile skip; B2 sums the GQA group inside one block, without atomics,
  so gradients are bitwise reproducible.
* :func:`flash_attention_bwd_torch` is their plain version, a port of
  ``ops._xla_flash_bwd``: the same recompute, ``+ dlse`` term and skip
  predicate.

The forward returns the TokenRing partial ``(out, lse)``; rows that see no
key give ``out = 0, lse = -inf`` and, in the backward, exactly zero
gradients.

**Fake tensors** (``torch._subclasses.fake_tensor``, which the dry run,
``launch/dryrun.py``, traces a step on: CUDA fakes where the build has CUDA,
CPU fakes where it has not, since autograd needs the device's guard) take
each wrapper's *shape path*:
after the argument checks the wrapper allocates exactly what its launch
would (the outputs, and a decode call's partials by the split rule at
``DRYRUN_SM_COUNT``, an H100 SXM5's SMs), hands the call to every observer
in ``FAKE_CALL_OBSERVERS`` (``launch.step_analysis`` counts its flops by the
tile skip) and returns, launching nothing and counting no launch.  A fake
tensor holds no data, so no kernel could take it; a real tensor never takes
this path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import NEG_INF, PAD_POS, visibility_mask

__all__ = [
    "flash_attention_fwd_cuda",
    "flash_attention_fwd_torch",
    "flash_fwd_instance",
    "flash_fwd_instance_built",
    "flash_fwd_smem_bytes",
    "wgmma_fwd_tiling",
    "core_fwd_tiling",
    "core_dq_tiling",
    "core_dkv_tiling",
    "core_smem_bytes",
    "decode_split_rule",
    "decode_rule_d256",
    "decode_core_instance",
    "decode_scratch",
    "flash_attention_bwd_dq_cuda",
    "flash_attention_bwd_dkv_cuda",
    "flash_attention_bwd_torch",
    "flash_bwd_instance",
    "flash_bwd_smem_bytes",
    "wgmma_bwd_tiling",
    "tile_skip",
    "tile_skip_grid",
    "tile_mask",
    "check_kernel_args",
    "is_fake",
    "report_fake_call",
    "FAKE_CALL_OBSERVERS",
    "DRYRUN_SM_COUNT",
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
             "flash_fwd_takes_wgmma": [ctypes.c_int] * 3,
             "flash_fwd_wgmma_smem": [ctypes.c_int] * 2,
             "flash_fwd_core_smem": [ctypes.c_int] * 2,
             "decode_takes_cluster": [ctypes.c_int] * 2,
             "decode_cluster_max_active": [ctypes.c_int],
             "decode_cluster_smem": [],
             "decode_split_smem": [ctypes.c_int] * 5}
_BWD_ARGTYPES = {
    "flash_bwd_dq": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                    ctypes.c_void_p],
    "flash_bwd_dkv": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                     ctypes.c_void_p],
    "flash_bwd_takes_wgmma": [ctypes.c_int] * 2,
    "flash_bwd_wgmma_smem": [ctypes.c_int] * 3,
    "flash_bwd_dq_core_smem": [ctypes.c_int] * 2,
    "flash_bwd_dkv_core_smem": [ctypes.c_int] * 2,
}


# Head dims each kernel is built for: A, B1 and B2 take recurrentgemma's
# 256 (on their wgmma instances in bf16, the CUDA cores in float32, and A's
# Sq <= 4 calls on the decode core); kernel C takes 256 on the decode
# core's D-256 instances too.
FLASH_DIMS = (32, 64, 128, 256)
PAGED_DIMS = (32, 64, 128, 256)
# The decode core's D-256 instances (bf16: the cluster instance, one m16
# tile of rows; float32: the split kernel's 16-row layout) hold 1 to 16 rows
# (GQA group x Sq) a KV head: recurrentgemma's group 10 at Sq 1.
DECODE_ROWS_D256 = (1, 16)


def check_kernel_args(name: str, device, dtype, D: int, ints=(), floats=(),
                      dims=FLASH_DIMS):
    """The checks every kernel wrapper runs before handing pointers to C:
    a head dim in ``dims`` (checked first), one CUDA device (one device of
    fake tensors: module docstring), a supported dtype, contiguous
    tensors."""
    if D not in dims:
        raise ValueError(f"{name}: head dim {D} not supported "
                         f"({', '.join(map(str, dims))})")
    for t in (*floats, *ints):
        if not (t.is_cuda or is_fake(t)) or t.device != device:
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


def check_decode_rows(name: str, D: int, group: int, Sq: int):
    """Raise unless the decode core has an instance for ``group * Sq`` rows
    a KV head at head dim ``D`` (every count up to 64 a block below D 256;
    ``DECODE_ROWS_D256`` at 256)."""
    lo, hi = DECODE_ROWS_D256
    if D == 256 and not lo <= group * Sq <= hi:
        raise ValueError(f"{name}: the D-256 decode instances take {lo} to {hi} rows a KV "
                         f"head (GQA group x Sq), got {group} x {Sq} = {group * Sq}")


def check_aligned(name: str, *tensors):
    """Raise unless every tensor starts on a 16-byte boundary (the decode
    core and the CUDA-core instances copy rows 16 bytes at a time)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def flash_fwd_instance(dtype, Sq: int, D: int) -> str:
    """Which instance of kernel A takes a call: ``"decode"`` (every call with
    ``Sq <= 4``), ``"wgmma"`` (bf16, ``D`` 64, 128 or 256, ``Sq > 4``) or
    ``"cuda_core"`` (the rest: float32, and ``D = 32``, with ``Sq > 4``).
    Mirrors ``takes_decode`` and ``takes_wgmma`` in ``csrc/flash_fwd.cu``."""
    if Sq <= DECODE_MAX_SQ:
        return "decode"
    if dtype == torch.bfloat16 and D in (64, 128, 256):
        return "wgmma"
    return "cuda_core"


def wgmma_fwd_tiling(D: int) -> dict:
    """The wgmma instance's tiling at head dim ``D`` (``Tiling<D>`` in
    ``csrc/flash_fwd.cu``): q rows a block, keys a KV tile and O columns a
    consumer warpgroup.  Up to D 128 the two consumers split a 128-row
    q-tile by rows (every column of O each) over 128-key tiles; at D 256
    both take the same 64-row q-tile, each forming S itself and holding half
    of O's columns, over 64-key tiles."""
    if D not in (64, 128, 256):
        raise ValueError(f"wgmma_fwd_tiling: no wgmma instance at head dim {D}")
    by_cols = D > 128
    return dict(q_rows=64 if by_cols else 128, keys=64 if by_cols else 128,
                o_cols=D // 2 if by_cols else D)


# The CUDA-core instances of A, B1 and B2 (``core::Fwd`` in
# csrc/flash_fwd.cu, ``core::Dq`` and ``core::Dkv`` in csrc/flash_bwd.cu):
# a ring of CORE_STAGES tiles fed by cp.async, and the walk's live tiles
# listed CORE_FLAG_CHUNK at a time.
CORE_STAGES = 2
CORE_FLAG_CHUNK = 256


def core_fwd_tiling(D: int) -> dict:
    """Kernel A's CUDA-core tiling at head dim ``D`` (``core::Fwd<T, D>``):
    q rows a block and keys a KV tile.  64 x 64 up to D 128; at D 256 the
    KV tiles are 32 keys, so that Q and two stages of K and V fit the
    block's shared memory."""
    if D not in FLASH_DIMS:
        raise ValueError(f"core_fwd_tiling: no CUDA-core instance at head dim {D}")
    return dict(q_rows=64, keys=32 if D == 256 else 64)


def core_dq_tiling(D: int) -> dict:
    """Kernel B1's CUDA-core tiling at head dim ``D`` (``core::Dq<T, D>``):
    q rows a block and keys a KV tile.  64 x 64 up to D 128; 32 x 32 at D
    256, so that Q, dout and two stages of K and V fit the block's shared
    memory."""
    if D not in FLASH_DIMS:
        raise ValueError(f"core_dq_tiling: no CUDA-core instance at head dim {D}")
    side = 32 if D == 256 else 64
    return dict(q_rows=side, keys=side)


def core_dkv_tiling(D: int) -> dict:
    """Kernel B2's CUDA-core tiling at head dim ``D`` (``core::Dkv<T, D>``):
    keys a block and q rows a tile of its walk.  32-key blocks (twice the
    blocks of 64-key ones, so that the causal grid's heaviest blocks are
    short enough to balance over the SMs) and 64-row q-tiles; 32-row
    q-tiles at D 256, so that K, V and two stages of Q and dout fit."""
    if D not in FLASH_DIMS:
        raise ValueError(f"core_dkv_tiling: no CUDA-core instance at head dim {D}")
    return dict(keys=32, q_rows=32 if D == 256 else 64)


# The split-KV decode core (csrc/decode.cuh), shared by kernel A's decode
# instance and kernel C.
DECODE_MAX_SQ = 4  # query rows per batch row that A's decode instance takes
DECODE_TILE_KEYS = 32  # keys per KV tile (csrc kTK)
DECODE_MAX_ROWS = 64  # query rows (group x Sq) one block holds (csrc kMaxRows)
DECODE_MAX_SPLIT_TILES = 64  # tiles of one split at most (csrc kMaxSplitTiles)
DECODE_BLOCKS_PER_SM = 4  # blocks the split rule aims for on each SM
# Blocks of one cluster at most (csrc dcl::kMaxCluster): an H100 holds 15
# clusters of 8 of its blocks at once but only 7 of 16, one short of a
# single wave at recurrentgemma's batch of 8.
DECODE_D256_MAX_CLUSTER = 8


def decode_core_instance(dtype, D: int) -> str:
    """Which decode kernel takes a decode call (A's Sq <= 4, and C):
    ``"cluster"`` (bf16 at D 256, ``csrc/decode_d256.cuh``) or ``"split"``
    (the rest, ``csrc/decode.cuh``).  Mirrors ``takes_cluster`` there."""
    return "cluster" if dtype == torch.bfloat16 and D == 256 else "split"


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


def decode_rule_d256(n_keys: int, units: int, sm_count: int) -> tuple[int, int]:
    """``(tiles_per_block, cluster)`` of a call on the cluster instance over
    ``n_keys`` keys with ``units`` clusters (batch rows x KV heads) on a card
    of ``sm_count`` SMs: one wave, about one block an SM.  ``G`` is the
    largest power of two up to ``DECODE_D256_MAX_CLUSTER`` and the tile
    count with ``units * G <= sm_count`` (at least 1); each block streams
    ``ceil(tiles / G)`` tiles, and the cluster is the blocks that have a
    tile, ``ceil(tiles / tiles_per_block)``, as the kernel derives it."""
    n_tiles = max(1, -(-n_keys // DECODE_TILE_KEYS))
    G = 1
    while 2 * G <= min(DECODE_D256_MAX_CLUSTER, n_tiles) and units * 2 * G <= sm_count:
        G *= 2
    per = -(-n_tiles // G)
    return per, -(-n_tiles // per)


def decode_units(B: int, Hq: int, Hkv: int, Sq: int) -> int:
    """Blocks of one split: batch rows x KV heads x chunks of
    ``DECODE_MAX_ROWS`` query rows (the GQA group x Sq)."""
    return B * Hkv * -(-(Hq // Hkv) * Sq // DECODE_MAX_ROWS)


_SM_COUNT: dict[int, int] = {}
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def decode_scratch(device, dtype, B: int, Sq: int, Hq: int, Hkv: int, D: int, n_keys: int,
                   *, fake: bool = False):
    """What a decode launch needs besides its inputs: ``tiles_per_split``
    and the float32 partials ``(part_out, part_lse)`` plus the int32 merge
    counters, or three ``None`` when one split covers the range or the
    cluster instance takes the call (its blocks merge in shared memory).
    The counters are zero at rest and every launch leaves them zero;
    launches on one stream run one after another, so one buffer per
    (device, current stream) serves every call, and launches on two streams
    at once never share one.  ``fake``: a shape path's call (module
    docstring), split at ``DRYRUN_SM_COUNT`` SMs, with counters of its own."""
    if fake:
        sm_count = DRYRUN_SM_COUNT
    else:
        idx = device.index if device.index is not None else torch.cuda.current_device()
        if idx not in _SM_COUNT:
            _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        sm_count = _SM_COUNT[idx]
    units = decode_units(B, Hq, Hkv, Sq)
    if decode_core_instance(dtype, D) == "cluster":
        return decode_rule_d256(n_keys, units, sm_count)[0], None, None, None
    per, splits = decode_split_rule(n_keys, units, sm_count)
    if splits == 1:
        return per, None, None, None
    rows = B * Sq * Hq
    if fake:
        counters = torch.zeros(units, dtype=torch.int32, device=device)
    else:
        key = (idx, torch.cuda.current_stream(idx).stream_id)
        counters = _COUNTERS.get(key)
        if counters is None or counters.numel() < units:
            counters = _COUNTERS[key] = torch.zeros(units, dtype=torch.int32, device=device)
    part_out = torch.empty((splits, rows, D), dtype=torch.float32, device=device)
    part_lse = torch.empty((splits, rows), dtype=torch.float32, device=device)
    return per, part_out, part_lse, counters


def is_fake(t) -> bool:
    """Whether ``t`` is a fake tensor: a shape and a device, no storage."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake

    return _is_fake(t)


# An H100 SXM5's SMs: the split rule's count on fake tensors, which have no
# card to ask.
DRYRUN_SM_COUNT = 132
# Callables ``(kernel, **call)`` that a wrapper's shape path reports to.
FAKE_CALL_OBSERVERS: list = []


def report_fake_call(kernel: str, *, q, Sk: int, q_pos, k_pos, causal: bool,
                     window: int | None, tiles: tuple[int, int], nbytes: int):
    """Hand one call on fake tensors to every observer: the kernel's name,
    its query tensor and key count, the positions (a paged call's ``k_pos``
    is ``(pos_pool, block_tables)``), the mask, the ``(q rows, keys)`` tiles
    its instance skips by and the bytes it reads and writes."""
    for obs in FAKE_CALL_OBSERVERS:
        obs(kernel, q=q, Sk=Sk, q_pos=q_pos, k_pos=k_pos, causal=causal, window=window,
            tiles=tiles, nbytes=nbytes)


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def flash_fwd_smem_bytes(D: int, Sk: int) -> int:
    """Dynamic shared memory of one block of the wgmma instance at head dim
    ``D`` (64, 128 or 256) over ``Sk`` keys: the tiles, the barriers and one
    flag a KV tile of :func:`wgmma_fwd_tiling` (builds the library on first
    use; needs the CUDA toolchain)."""
    from repro_torch.kernels._build import load_library

    return load_library("flash_fwd", _ARGTYPES).flash_fwd_wgmma_smem(D, Sk)


def core_smem_bytes(kernel: str, dtype, D: int) -> int:
    """Dynamic shared memory of one block of A's (``kernel="fwd"``), B1's
    (``"dq"``) or B2's (``"dkv"``) CUDA-core instance at head dim ``D`` and ``dtype`` (bf16 at
    D 32 only), as the built library states it (builds the library on first
    use; needs the CUDA toolchain)."""
    from repro_torch.kernels._build import load_library

    bf16 = int(dtype == torch.bfloat16)
    if kernel == "fwd":
        return load_library("flash_fwd", _ARGTYPES).flash_fwd_core_smem(D, bf16)
    lib = load_library("flash_bwd", _BWD_ARGTYPES)
    if kernel == "dq":
        return lib.flash_bwd_dq_core_smem(D, bf16)
    return lib.flash_bwd_dkv_core_smem(D, bf16)


def flash_fwd_instance_built(dtype, Sq: int, D: int) -> str:
    """:func:`flash_fwd_instance` as the built library decides it: the
    library's ``takes_wgmma``, then the decode instance for ``Sq <= 4`` and
    the CUDA cores for the rest (builds the library on first use; needs the
    CUDA toolchain)."""
    from repro_torch.kernels._build import load_library

    lib = load_library("flash_fwd", _ARGTYPES)
    if lib.flash_fwd_takes_wgmma(int(dtype == torch.bfloat16), D, Sq):
        return "wgmma"
    return "decode" if Sq <= DECODE_MAX_SQ else "cuda_core"


def decode_core_instance_built(dtype, D: int) -> str:
    """:func:`decode_core_instance` as the built library decides it (builds
    the library on first use; needs the CUDA toolchain)."""
    from repro_torch.kernels._build import load_library

    lib = load_library("flash_fwd", _ARGTYPES)
    return "cluster" if lib.decode_takes_cluster(int(dtype == torch.bfloat16), D) else "split"


def decode_split_smem_bytes(dtype, D: int, rows: int, tiles_per_split: int, *,
                            paged: bool) -> int:
    """Dynamic shared memory of one block of the split decode kernel at
    ``rows`` (GQA group x Sq) a KV head and ``tiles_per_split``, dense
    (kernel A) or paged (kernel C) (builds the library on first use; needs
    the CUDA toolchain)."""
    from repro_torch.kernels._build import load_library

    return load_library("flash_fwd", _ARGTYPES).decode_split_smem(
        int(dtype == torch.bfloat16), D, rows, int(paged), tiles_per_split)


def decode_cluster_occupancy(cluster: int) -> tuple[int, int]:
    """``(clusters, smem_bytes)``: how many clusters of ``cluster`` blocks of
    the cluster instance the card holds at once at the block's dynamic
    shared memory (``cudaOccupancyMaxActiveClusters``), and that memory
    (builds the library on first use; needs the card)."""
    from repro_torch.kernels._build import load_library

    lib = load_library("flash_fwd", _ARGTYPES)
    n = lib.decode_cluster_max_active(cluster)
    _raise_on(-n if n < 0 else 0, "decode_cluster_max_active")
    return n, lib.decode_cluster_smem()


def flash_bwd_instance(dtype, D: int) -> str:
    """Which instance of kernels B1 and B2 takes a call: ``"wgmma"`` (bf16,
    ``D`` 64, 128 or 256) or ``"cuda_core"`` (float32, and ``D = 32``).
    Mirrors ``takes_wgmma_bwd`` in ``csrc/flash_bwd.cu``."""
    if dtype == torch.bfloat16 and D in (64, 128, 256):
        return "wgmma"
    return "cuda_core"


def wgmma_bwd_tiling(D: int) -> dict:
    """The wgmma instances' tiling at head dim ``D`` (``DqSplit``,
    ``DkvSplit`` and the key and row constants of ``csrc/flash_bwd.cu``):
    B1's q rows a block and keys a KV tile; B2's keys a block, q rows a
    tile and blocks sharing one key tile.  Up to D 128 B1's two consumers
    split a 128-row q-tile by rows; at D 256 both take the same 64-row
    q-tile, each half of dQ's columns, and two B2 blocks share a 64-key
    tile, each half of dK's and dV's columns."""
    if D not in (64, 128, 256):
        raise ValueError(f"wgmma_bwd_tiling: no wgmma instance at head dim {D}")
    by_cols = D > 128
    return dict(dq_rows=64 if by_cols else 128, dq_keys=64, dkv_keys=64, dkv_rows=64,
                dkv_blocks=2 if by_cols else 1)


def flash_bwd_smem_bytes(kernel: str, D: int, S: int) -> int:
    """Dynamic shared memory of one block of B1's (``kernel="dq"``, at
    ``Sk = S``) or B2's (``"dkv"``, at ``Sq = S``) wgmma instance (builds the
    library on first use; needs the CUDA toolchain)."""
    from repro_torch.kernels._build import load_library

    return load_library("flash_bwd", _BWD_ARGTYPES).flash_bwd_wgmma_smem(
        int(kernel == "dkv"), D, S)


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
    instance = flash_fwd_instance(q.dtype, Sq, D)
    fake = is_fake(q)
    if instance == "cuda_core" and not fake:
        check_aligned("flash_attention_fwd_cuda", q, k, v)
    if instance == "decode":
        check_decode_rows("flash_attention_fwd_cuda", D, Hq // Hkv, Sq)
        if not fake:
            check_aligned("flash_attention_fwd_cuda", *((q, k, v) if decode_core_instance(
                q.dtype, D) == "cluster" else (k, v)))
        per, part_out, part_lse, counters = decode_scratch(q.device, q.dtype, B, Sq, Hq, Hkv,
                                                           D, Sk, fake=fake)
    if fake:
        tiles = ((Sq, DECODE_TILE_KEYS) if instance == "decode" else
                 tuple(wgmma_fwd_tiling(D)[k] for k in ("q_rows", "keys"))
                 if instance == "wgmma" else tuple(core_fwd_tiling(D).values()))
        report_fake_call("flash_attention_fwd", q=q, Sk=Sk, q_pos=q_pos, k_pos=k_pos,
                         causal=causal, window=window, tiles=tiles,
                         nbytes=tensor_bytes(q, k, v, q_pos, k_pos, out, lse))
        return out, lse
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


def _report_bwd(name, q, k, v, q_pos, k_pos, dout, lse, delta, dlse, outs, causal, window):
    """The shape path's report of a B1 or B2 call, at its instance's tiles."""
    D = q.shape[-1]
    dq_kernel = name.endswith("_dq_cuda")
    if flash_bwd_instance(q.dtype, D) == "wgmma":
        t = wgmma_bwd_tiling(D)
        tiles = (t["dq_rows"], t["dq_keys"]) if dq_kernel else (t["dkv_rows"], t["dkv_keys"])
    else:
        t = core_dq_tiling(D) if dq_kernel else core_dkv_tiling(D)
        tiles = (t["q_rows"], t["keys"])
    report_fake_call(name[:-len("_cuda")], q=q, Sk=k.shape[1], q_pos=q_pos, k_pos=k_pos,
                     causal=causal, window=window, tiles=tiles,
                     nbytes=tensor_bytes(q, k, v, q_pos, k_pos, dout, lse, delta, dlse, *outs))


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
    if is_fake(q):
        _report_bwd(name, q, k, v, q_pos, k_pos, dout, lse, delta, dlse, (dq,), causal,
                    window)
        return dq
    if flash_bwd_instance(q.dtype, q.shape[-1]) == "cuda_core":
        check_aligned(name, q, k, v, dout)
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
    if is_fake(q):
        _report_bwd(name, q, k, v, q_pos, k_pos, dout, lse, delta, dlse, (dk, dv), causal,
                    window)
        return dk, dv
    if flash_bwd_instance(q.dtype, q.shape[-1]) == "cuda_core":
        check_aligned(name, q, k, v, dout)
    err = load_library("flash_bwd", _BWD_ARGTYPES).flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dlse.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_bwd_scalars(q, k, causal, window, scale))
    _raise_on(err, name)
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dq_cuda.launches = 0
flash_attention_bwd_dkv_cuda.launches = 0

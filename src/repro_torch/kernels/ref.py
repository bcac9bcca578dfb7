"""Plain-torch attention oracle: the full score matrix in float32.

Counterpart of ``repro.kernels.ref``.  Layout convention (framework-wide):
    q:   (B, Sq, Hq,  D)
    k,v: (B, Sk, Hkv, D)     with Hq % Hkv == 0  (GQA; Hq == Hkv is MHA)
    out: (B, Sq, Hq,  D)     in q.dtype
    lse: (B, Sq, Hq)         float32

Masking is position-based (``q_pos``/``k_pos`` are global token positions,
``(B, S)`` or ``(S,)``).  Keys at ``>= PAD_POS // 2`` are padding.  A fully
masked query row returns ``out = 0`` and ``lse = -inf``.
"""

from __future__ import annotations

import torch

__all__ = ["attention_reference", "blockwise_reference", "normalize_positions", "NEG_INF",
           "PAD_POS"]

NEG_INF = float(torch.finfo(torch.float32).min)
PAD_POS = 2**30  # sentinel position of padded / unwritten KV rows


def normalize_positions(pos, B: int, S: int, device=None) -> torch.Tensor:
    """Accept ``None``, ``(S,)`` or ``(B, S)`` int positions; return ``(B, S)`` int32."""
    if pos is None:
        pos = torch.arange(S, dtype=torch.int32, device=device)
    pos = torch.as_tensor(pos, device=device).to(torch.int32)
    if pos.ndim == 1:
        pos = pos[None, :].expand(B, S)
    return pos


def visibility_mask(q_pos, k_pos, *, causal: bool, window: int | None):
    """``(B, Sq, Sk)`` key visibility: padding, causal and window terms."""
    mask = (k_pos[:, None, :] < PAD_POS // 2).expand(
        q_pos.shape[0], q_pos.shape[1], k_pos.shape[1]
    )
    if causal:
        mask = mask & (q_pos[:, :, None] >= k_pos[:, None, :])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    return mask


def attention_reference(q, k, v, *, causal: bool = False, q_pos=None, k_pos=None,
                        scale: float | None = None, window: int | None = None):
    """Naive full-matrix attention in float32 -> ``(out, lse)``."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (D**0.5)
    q_pos = normalize_positions(q_pos, B, Sq, q.device)
    k_pos = normalize_positions(k_pos, B, Sk, q.device)
    group = Hq // Hkv
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kf)
    mask = visibility_mask(q_pos, k_pos, causal=causal, window=window)[:, None]
    scores = torch.where(mask, scores, NEG_INF)
    row_max = scores.amax(dim=-1, keepdim=True)
    safe_max = torch.where(row_max <= NEG_INF / 2, 0.0, row_max)
    unnorm = torch.where(mask, torch.exp(scores - safe_max), 0.0)
    denom = unnorm.sum(dim=-1, keepdim=True)
    any_valid = denom > 0.0
    out = torch.einsum("bhqk,bkhd->bqhd", unnorm, vf)
    out = out / torch.where(any_valid, denom, 1.0).transpose(1, 2)
    out = torch.where(any_valid.transpose(1, 2), out, 0.0)
    lse = safe_max[..., 0] + torch.log(torch.where(any_valid, denom, 1.0)[..., 0])
    lse = torch.where(any_valid[..., 0], lse, -torch.inf)
    return out.to(q.dtype), lse.transpose(1, 2)


def blockwise_reference(q, k, v, *, block_k: int, causal: bool = False, q_pos=None, k_pos=None,
                        scale: float | None = None):
    """Attention over KV blocks of ``block_k`` keys, merged with
    ``core.merge``: the one-device analogue of what the ring strategies do
    across ranks, to check the merge apart from any schedule."""
    from repro_torch.core.merge import empty_partial, finalize, merge_partials

    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    if Sk % block_k:
        raise ValueError(f"block_k {block_k} does not divide Sk {Sk}")
    k_pos = normalize_positions(k_pos, B, Sk, q.device)
    out, lse = empty_partial((B, Sq, Hq, D), device=q.device)
    for start in range(0, Sk, block_k):
        blk = slice(start, start + block_k)
        o, l = attention_reference(q, k[:, blk], v[:, blk], causal=causal, q_pos=q_pos,
                                   k_pos=k_pos[:, blk], scale=scale)
        out, lse = merge_partials(out, lse, o, l)
    out, lse = finalize(out, lse)
    return out.to(q.dtype), lse

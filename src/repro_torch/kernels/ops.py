"""Public attention entry points and their dispatch (port of ``repro.kernels.ops``).

``impl`` picks the implementation:
  * ``"cuda"``  — the hand-written kernels (``csrc/``); CUDA tensors only,
    anything else raises;
  * ``"torch"`` — the plain versions (CPU, or an explicit comparison on the
    card);
  * ``"auto"``  — the kernel for CUDA tensors, the plain version for CPU
    tensors.

A CUDA tensor under ``"auto"`` or ``"cuda"`` goes to the kernel or the call
raises: there is no fallback.  :func:`flash_attention` is differentiable:
when grad is enabled it runs through :class:`FlashAttentionFn`, the
counterpart of ``_flash``'s custom VJP, whose backward is kernels B1/B2 on
the card (the plain blockwise backward on the CPU).  Without grad it calls
the forward directly; the serving steps run under ``inference_mode``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_dkv_cuda,
    flash_attention_bwd_dq_cuda,
    flash_attention_bwd_torch,
    flash_attention_fwd_cuda,
    flash_attention_fwd_torch,
    is_fake,
)
from repro_torch.kernels.flash_attention import tile_skip_grid as _tile_skip_grid
from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda, paged_decode_fwd_torch
from repro_torch.kernels.ref import normalize_positions

__all__ = [
    "FlashConfig",
    "FlashAttentionFn",
    "flash_attention",
    "backward_tile_counts",
    "paged_decode_attention",
    "check_tile_divisible",
    "pick_block",
]

IMPLS = ("auto", "cuda", "torch")


@dataclass(frozen=True)
class FlashConfig:
    """Masks, tiles and implementation of one flash call.  The tiles tile
    the plain versions; the kernels tile by their own constants."""

    causal: bool = False
    window: int | None = None
    scale: float | None = None
    block_q: int = 512
    block_k: int = 512
    block_q_bwd: int | None = None  # None inherits block_q
    block_k_bwd: int | None = None  # None inherits block_k
    impl: str = "auto"  # auto | cuda | torch

    @property
    def bwd_block_q(self) -> int:
        return self.block_q_bwd if self.block_q_bwd is not None else self.block_q

    @property
    def bwd_block_k(self) -> int:
        return self.block_k_bwd if self.block_k_bwd is not None else self.block_k

    def resolve_impl(self, device: torch.device, fake: bool = False) -> str:
        """``"cuda"`` or ``"torch"`` for tensors on ``device``; ``fake``
        tensors (a dry run's, ``kernels.flash_attention``'s shape path) count
        as the card's whatever their device: a build without CUDA cannot run
        autograd on fake CUDA tensors, so the dry run traces fake CPU ones
        there."""
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; expected one of {IMPLS}")
        if fake and self.impl != "torch":
            return "cuda"
        if self.impl == "auto":
            return "cuda" if device.type == "cuda" else "torch"
        if self.impl == "cuda" and device.type != "cuda":
            raise ValueError(
                f"impl='cuda' needs CUDA tensors, got tensors on {device}; pass "
                "impl='torch' (or 'auto') to run the plain version on the CPU"
            )
        return self.impl


def check_tile_divisible(s: int, target: int) -> str | None:
    """PRE-TILE-DIV of the precondition catalog (``analysis.preconditions``
    routes its findings here): a sequence that needs tiling must admit a
    power-of-two tile of at least 8 rows."""
    b = min(target, s)
    while s % b:
        b //= 2
    if s > target and b < min(8, target):
        return (
            f"sequence length {s} has no power-of-two tile in "
            f"[{min(8, target)}, {target}] (best divisor: {b}); pad it to a "
            f"multiple of 8 (masked PAD_POS sentinel rows are free) or pass "
            f"a block size that divides it"
        )
    return None


def pick_block(s: int, target: int) -> int:
    """Largest power-of-two block ``<= target`` dividing ``s`` (``s`` itself
    if small); raises ``ValueError`` when only sub-8-row tiles remain."""
    msg = check_tile_divisible(s, target)
    if msg is not None:
        raise ValueError(msg)
    b = min(target, s)
    while s % b:
        b //= 2
    return b


def backward_tile_counts(q_pos, k_pos, *, block_q: int, block_k: int, causal: bool = False,
                         window: int | None = None):
    """``(computed, total)`` backward score tiles for a position layout,
    counted per (batch, q-tile, kv-tile) with the kernels' skip predicate
    (port of ``ops.backward_tile_counts``)."""
    bq = pick_block(q_pos.shape[1], block_q)
    bk = pick_block(k_pos.shape[1], block_k)
    skip = _tile_skip_grid(q_pos, k_pos, bq, bk, causal=causal, window=window)
    return skip.numel() - int(skip.sum()), skip.numel()


def _scale(cfg: FlashConfig, D: int) -> float:
    return cfg.scale if cfg.scale is not None else 1.0 / (D**0.5)


def _flash_fwd(cfg: FlashConfig, q, k, v, q_pos, k_pos):
    scale = _scale(cfg, q.shape[-1])
    if cfg.resolve_impl(q.device, is_fake(q)) == "cuda":
        return flash_attention_fwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), q_pos.contiguous(),
            k_pos.contiguous(), causal=cfg.causal, window=cfg.window, scale=scale,
        )
    return flash_attention_fwd_torch(q, k, v, q_pos, k_pos, causal=cfg.causal,
                                     window=cfg.window, scale=scale,
                                     block_k=pick_block(k.shape[1], cfg.block_k))


def _flash_bwd(cfg: FlashConfig, q, k, v, q_pos, k_pos, out, lse, dout, dlse):
    """``(dq, dk, dv)`` in float32: kernels B1 and B2, or the plain version."""
    scale = _scale(cfg, q.shape[-1])
    if cfg.resolve_impl(q.device, is_fake(q)) != "cuda":
        return flash_attention_bwd_torch(
            q, k, v, q_pos, k_pos, out, lse, dout, dlse, causal=cfg.causal,
            window=cfg.window, scale=scale, block_q=pick_block(q.shape[1], cfg.bwd_block_q),
            block_k=pick_block(k.shape[1], cfg.bwd_block_k),
        )
    dout = dout.contiguous()
    # delta = rowsum(dout * out) stays outside the kernels, as in the Pallas wrapper
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    dlse = torch.zeros_like(lse) if dlse is None else dlse.float().contiguous()
    args = (q.contiguous(), k.contiguous(), v.contiguous(), q_pos.contiguous(),
            k_pos.contiguous(), dout, lse.contiguous(), delta, dlse)
    kw = dict(causal=cfg.causal, window=cfg.window, scale=scale)
    dq = flash_attention_bwd_dq_cuda(*args, **kw)
    dk, dv = flash_attention_bwd_dkv_cuda(*args, **kw)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``(out, lse)`` with a flash backward (the custom VJP of ``_flash``).

    Saves ``q, k, v, q_pos, k_pos, out, lse``; the backward takes both
    cotangents (an unused ``lse`` gives ``dlse`` None, taken as zero) and
    returns no gradient for the positions."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, cfg: FlashConfig):
        out, lse = _flash_fwd(cfg, q, k, v, q_pos, k_pos)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, out, lse)
        ctx.cfg = cfg
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, q_pos, k_pos, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = _flash_bwd(ctx.cfg, q, k, v, q_pos, k_pos, out, lse, dout, dlse)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(q, k, v, *, q_pos=None, k_pos=None, causal: bool = False,
                    window: int | None = None, scale: float | None = None,
                    block_q: int = 512, block_k: int = 512, block_q_bwd: int | None = None,
                    block_k_bwd: int | None = None, impl: str = "auto"):
    """Flash attention returning the TokenRing partial ``(out, lse)``.

    ``q (B,Sq,Hq,D)``, ``k/v (B,Sk,Hkv,D)``; ``q_pos``/``k_pos`` default to
    ``arange``.  The tiles (``block_*_bwd`` None inherit the forward's) tile
    the plain versions and are validated for every impl.  Differentiable in
    ``q``, ``k``, ``v`` and ``lse``.
    """
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    q_pos = normalize_positions(q_pos, B, Sq, q.device)
    k_pos = normalize_positions(k_pos, B, Sk, q.device)
    cfg = FlashConfig(causal=causal, window=window, scale=scale, block_q=block_q,
                      block_k=block_k, block_q_bwd=block_q_bwd, block_k_bwd=block_k_bwd,
                      impl=impl)
    for s, b in ((Sq, block_q), (Sk, block_k), (Sq, cfg.bwd_block_q), (Sk, cfg.bwd_block_k)):
        pick_block(s, b)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, q_pos, k_pos, cfg)
    return _flash_fwd(cfg, q, k, v, q_pos, k_pos)


@torch.inference_mode()
def paged_decode_attention(q, k_pool, v_pool, pos_pool, block_tables, q_pos, *,
                           lengths=None, window: int | None = None,
                           scale: float | None = None, block_k: int | None = None,
                           impl: str = "auto"):
    """Paged decode attention over a page pool -> ``(out, lse)``.

    ``q (B,1,Hq,D)``, pools ``(n_pages,ps,Hkv,D)``, ``pos_pool (n_pages,ps)``,
    ``block_tables (B,W)`` (entries ``>= n_pages`` unmapped), ``q_pos (B,1)``,
    ``lengths (B,)`` used lengths (clamps the plain version's gathered view;
    the kernel masks by the pool's PAD positions and needs none).
    """
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if FlashConfig(impl=impl).resolve_impl(q.device, is_fake(q)) == "cuda":
        return paged_decode_fwd_cuda(
            q.contiguous(), k_pool, v_pool, pos_pool, block_tables.to(torch.int32).contiguous(),
            q_pos.to(torch.int32).contiguous(), window=window, scale=scale,
        )
    return paged_decode_fwd_torch(
        q, k_pool, v_pool, pos_pool, block_tables, q_pos.to(torch.int32), lengths=lengths,
        window=window, scale=scale, block_k=block_k if block_k is not None else 512,
    )

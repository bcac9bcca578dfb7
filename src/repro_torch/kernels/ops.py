"""Public attention entry points and their dispatch (port of ``repro.kernels.ops``).

``impl`` picks the implementation:
  * ``"cuda"``  — the hand-written kernels (``csrc/``); CUDA tensors only,
    anything else raises;
  * ``"torch"`` — the plain versions (CPU, or an explicit comparison on the
    card);
  * ``"auto"``  — the kernel for CUDA tensors, the plain version for CPU
    tensors.

A CUDA tensor under ``"auto"`` or ``"cuda"`` goes to the kernel or the call
raises: there is no fallback.  Both entry points are forward only and run
under ``torch.inference_mode()``; the ``autograd.Function`` comes with the
backward kernels of the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.flash_attention import (
    flash_attention_fwd_cuda,
    flash_attention_fwd_torch,
)
from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda, paged_decode_fwd_torch
from repro_torch.kernels.ref import normalize_positions

__all__ = [
    "FlashConfig",
    "flash_attention",
    "paged_decode_attention",
    "check_tile_divisible",
    "pick_block",
]

IMPLS = ("auto", "cuda", "torch")


@dataclass(frozen=True)
class FlashConfig:
    """Which implementation serves a call (the tiles and masks are the
    entry points' arguments)."""

    impl: str = "auto"  # auto | cuda | torch

    def resolve_impl(self, device: torch.device) -> str:
        """``"cuda"`` or ``"torch"`` for tensors on ``device``."""
        if self.impl not in IMPLS:
            raise ValueError(f"unknown impl {self.impl!r}; expected one of {IMPLS}")
        if self.impl == "auto":
            return "cuda" if device.type == "cuda" else "torch"
        if self.impl == "cuda" and device.type != "cuda":
            raise ValueError(
                f"impl='cuda' needs CUDA tensors, got tensors on {device}; pass "
                "impl='torch' (or 'auto') to run the plain version on the CPU"
            )
        return self.impl


def check_tile_divisible(s: int, target: int) -> str | None:
    """A sequence that needs tiling must admit a power-of-two tile of at
    least 8 rows (copy of ``repro.analysis.preconditions``)."""
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


@torch.inference_mode()
def flash_attention(q, k, v, *, q_pos=None, k_pos=None, causal: bool = False,
                    window: int | None = None, scale: float | None = None,
                    block_q: int = 512, block_k: int = 512, impl: str = "auto"):
    """Flash attention returning the TokenRing partial ``(out, lse)``.

    ``q (B,Sq,Hq,D)``, ``k/v (B,Sk,Hkv,D)``; ``q_pos``/``k_pos`` default to
    ``arange``.  ``block_q``/``block_k`` tile the plain version and are
    validated for every impl (the kernel tiles by its own constants).
    """
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    q_pos = normalize_positions(q_pos, B, Sq, q.device)
    k_pos = normalize_positions(k_pos, B, Sk, q.device)
    pick_block(Sq, block_q)
    bk = pick_block(Sk, block_k)
    scale = scale if scale is not None else 1.0 / (D**0.5)
    if FlashConfig(impl=impl).resolve_impl(q.device) == "cuda":
        return flash_attention_fwd_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), q_pos.contiguous(),
            k_pos.contiguous(), causal=causal, window=window, scale=scale,
        )
    return flash_attention_fwd_torch(q, k, v, q_pos, k_pos, causal=causal, window=window,
                                     scale=scale, block_k=bk)


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
    if FlashConfig(impl=impl).resolve_impl(q.device) == "cuda":
        return paged_decode_fwd_cuda(
            q.contiguous(), k_pool, v_pool, pos_pool, block_tables.to(torch.int32).contiguous(),
            q_pos.to(torch.int32).contiguous(), window=window, scale=scale,
        )
    return paged_decode_fwd_torch(
        q, k_pool, v_pool, pos_pool, block_tables, q_pos.to(torch.int32), lengths=lengths,
        window=window, scale=scale, block_k=block_k if block_k is not None else 512,
    )

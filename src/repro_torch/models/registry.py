"""Model registry: one bundle of training and serving callables per family
(port of ``repro.models.registry``).  The dense, MoE and VLM families share
the transformer bundle, as in the JAX package; the recurrent families
(``"ssm"``, ``"hybrid"``) and ``"encdec"`` are not ported yet (ROADMAP
queue 1 items 9a and 9b).  The serve-state initialisers lay the cache out
for the bundle's ``pctx`` (sequence-sharded over its ring when
``sp_degree > 1``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, ClassVar

import torch

from repro_torch.core.api import ParallelContext
from repro_torch.models.config import ArchConfig

__all__ = ["ModelBundle", "build_model"]


@dataclass
class ModelBundle:
    cfg: ArchConfig
    pctx: ParallelContext
    init: Callable[..., Any]  # (seed, training=False) -> params on pctx.device
    loss: Callable[..., Any]  # (params, batch) -> (loss, metrics)
    decode_step: Callable[..., Any]  # (params, tokens (B,), state, active=None)
    init_serve_state: Callable[..., Any]  # (batch, max_len, device)
    prefill_chunk: Callable[..., Any]  # (params, tokens (B,C), state, n_valid (B,))
    decode_step_paged: Callable[..., Any]
    prefill_chunk_paged: Callable[..., Any]
    init_paged_state: Callable[..., Any]  # (n_pages, page_size, max_batch, slot_pages, device)
    # one-shot prefill into the dense slab: (params, tokens, positions, state,
    # prefix_embeds=None) -> (logits, state); a VLM's image prefix needs it
    prefill: Callable[..., Any] | None = None
    # the serve state is cache-style (per-slot len/pos, position masked), so a
    # step fed a dummy token can be rolled back by its length: true of every
    # family the port builds, all on the transformer bundle
    decode_rollback_safe: ClassVar[bool] = True


def build_model(cfg: ArchConfig, pctx: ParallelContext) -> ModelBundle:
    from repro_torch.models import transformer as T

    if cfg.family not in T.FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1 items 9a and 9b: "
            "the recurrent families and encdec); the port builds "
            + ", ".join(T.FAMILIES))

    def init(seed: int, training: bool = False):
        gen = torch.Generator(device=pctx.device).manual_seed(seed)
        return T.init_lm(cfg, gen, device=pctx.device, training=training)

    return ModelBundle(
        cfg=cfg,
        pctx=pctx,
        init=init,
        loss=lambda params, batch: T.lm_loss(params, batch, cfg=cfg, pctx=pctx),
        decode_step=lambda params, tok, state, active=None: T.lm_decode_step(
            params, tok, state, active, cfg=cfg, pctx=pctx),
        init_serve_state=lambda B, max_len, device: T.init_decode_cache(
            cfg, B, max_len, device=device, pctx=pctx),
        prefill_chunk=lambda params, tok, state, n_valid: T.lm_prefill_chunk(
            params, tok, state, n_valid, cfg=cfg, pctx=pctx),
        decode_step_paged=lambda params, tok, state, active=None: T.lm_decode_step_paged(
            params, tok, state, active, cfg=cfg, pctx=pctx),
        prefill_chunk_paged=lambda params, tok, state, n_valid: T.lm_prefill_chunk_paged(
            params, tok, state, n_valid, cfg=cfg, pctx=pctx),
        init_paged_state=lambda n_pages, page_size, max_batch, slot_pages, device: (
            T.init_paged_decode_cache(cfg, n_pages=n_pages, page_size=page_size,
                                      max_batch=max_batch, slot_pages=slot_pages,
                                      device=device, pctx=pctx)),
        prefill=lambda params, tokens, positions, state, prefix_embeds=None: T.lm_prefill(
            params, tokens, positions, state, prefix_embeds, cfg=cfg, pctx=pctx),
    )

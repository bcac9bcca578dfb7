"""Model registry: one bundle of training and serving callables per family
(port of ``repro.models.registry``).  The dense, MoE and VLM families share
the transformer bundle, as in the JAX package; ``"encdec"`` (whisper) has
its own, with ``encode`` and no chunked or paged serving steps (the engine
prefills it token by token); ``"ssm"`` (falcon-mamba) has a training loss
through the sequence-parallel scan and an O(1) decode step, and no prefill
of any kind: its recurrent state cannot be rolled back per slot, so the
engine refuses it, as the JAX engine does, and it serves through
``decode_step`` alone; ``"hybrid"`` (recurrentgemma) likewise, its local
attention through kernel A's and B1/B2's head-dim-256 instances and its
decode state a K/V ring buffer of ``window`` slots beside the recurrent
state.  The serve-state initialisers lay the state out for the bundle's
``pctx``: caches sequence-sharded over its ring when ``sp_degree > 1``
(the dense slab, the cross K/V, the hybrid's ring buffer), the recurrent
state split by its width over the sequence axes of its mesh (``model``, or
``("pod", "model")`` on the pod mesh, model-major: ``layers.state_tp``;
``sharding.serve_state_shardings``).  Every family's ``decode_step``
takes whole parameters or serve storage (``sharding.shard_tree`` of a
``mode="serve"`` layout, the reference's Megatron layout for decode).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.api import ParallelContext
from repro_torch.models.config import ArchConfig, ShapeConfig

__all__ = ["ModelBundle", "build_model", "input_specs", "runnable"]


@dataclass
class ModelBundle:
    cfg: ArchConfig
    pctx: ParallelContext
    init: Callable[..., Any]  # (seed, training=False) -> params on pctx.device
    loss: Callable[..., Any]  # (params, batch) -> (loss, metrics)
    decode_step: Callable[..., Any]  # (params, tokens (B,), state[, active]) -> (logits, state)
    init_serve_state: Callable[..., Any]  # (batch, max_len, device)
    # Chunked serving prefill: (params, tokens (B,C), state, n_valid (B,)).
    # Families without it are prefilled token by token by the engine, which
    # is only sound when ``decode_rollback_safe`` is set.
    prefill_chunk: Callable[..., Any] | None = None
    # Paged serving: the page-pool counterparts of decode_step/prefill_chunk
    # and init_paged_state(n_pages, page_size, max_batch, slot_pages,
    # device); families without them serve from the dense slab only.
    decode_step_paged: Callable[..., Any] | None = None
    prefill_chunk_paged: Callable[..., Any] | None = None
    init_paged_state: Callable[..., Any] | None = None
    # one-shot prefill into the dense slab: (params, tokens, positions, state,
    # prefix_embeds=None) -> (logits, state); a VLM's image prefix needs it
    prefill: Callable[..., Any] | None = None
    # the serve state is cache-style (per-slot len/pos, position masked), so a
    # step fed a dummy token can be rolled back by its length; a recurrent
    # state cannot be
    decode_rollback_safe: bool = False
    # encoder-decoder: (params, frames (B, S_enc, d), state) -> state with
    # the cross K/V filled
    encode: Callable[..., Any] | None = None


def build_model(cfg: ArchConfig, pctx: ParallelContext) -> ModelBundle:
    from repro_torch.models import transformer as T

    if cfg.family == "encdec":
        return _encdec_bundle(cfg, pctx)
    if cfg.family == "ssm":
        return _ssm_bundle(cfg, pctx)
    if cfg.family == "hybrid":
        return _hybrid_bundle(cfg, pctx)
    if cfg.family not in T.FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the port builds "
                         + ", ".join((*T.FAMILIES, "encdec", "ssm", "hybrid")))

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
        decode_rollback_safe=True,
    )


def _encdec_bundle(cfg: ArchConfig, pctx: ParallelContext) -> ModelBundle:
    from repro_torch.models import encdec as E

    def init(seed: int, training: bool = False):
        gen = torch.Generator(device=pctx.device).manual_seed(seed)
        return E.init_encdec(cfg, gen, device=pctx.device, training=training)

    return ModelBundle(
        cfg=cfg,
        pctx=pctx,
        init=init,
        loss=lambda params, batch: E.encdec_loss(params, batch, cfg=cfg, pctx=pctx),
        decode_step=lambda params, tok, state: E.encdec_decode_step(
            params, tok, state, cfg=cfg, pctx=pctx),
        init_serve_state=lambda B, max_len, device: E.init_encdec_state(
            cfg, B, max_len, cfg.enc_seq, device=device, pctx=pctx),
        decode_rollback_safe=True,  # cache-style state (len/pos)
        encode=lambda params, frames, state: E.encdec_encode(
            params, frames, state, cfg=cfg, pctx=pctx),
    )


def _ssm_bundle(cfg: ArchConfig, pctx: ParallelContext) -> ModelBundle:
    from repro_torch.models import mamba as M

    def init(seed: int, training: bool = False):
        gen = torch.Generator(device=pctx.device).manual_seed(seed)
        return M.init_mamba_lm(cfg, gen, device=pctx.device, training=training)

    return ModelBundle(
        cfg=cfg,
        pctx=pctx,
        init=init,
        loss=lambda params, batch: M.mamba_loss(params, batch, cfg=cfg, pctx=pctx),
        decode_step=lambda params, tok, state: M.mamba_decode_step(
            params, tok, state, cfg=cfg, pctx=pctx),
        init_serve_state=lambda B, max_len, device: M.init_mamba_state(cfg, B, device=device,
                                                                       pctx=pctx),
        decode_rollback_safe=False,  # a recurrent state: no per-slot rollback
    )


def _hybrid_bundle(cfg: ArchConfig, pctx: ParallelContext) -> ModelBundle:
    from repro_torch.models import rglru as R

    def init(seed: int, training: bool = False):
        gen = torch.Generator(device=pctx.device).manual_seed(seed)
        return R.init_rg(cfg, gen, device=pctx.device, training=training)

    return ModelBundle(
        cfg=cfg,
        pctx=pctx,
        init=init,
        loss=lambda params, batch: R.rg_loss(params, batch, cfg=cfg, pctx=pctx),
        decode_step=lambda params, tok, state: R.rg_decode_step(
            params, tok, state, cfg=cfg, pctx=pctx),
        init_serve_state=lambda B, max_len, device: R.init_rg_state(cfg, B, device=device,
                                                                    pctx=pctx),
        decode_rollback_safe=False,  # a recurrent state: no per-slot rollback
    )


# ---------------------------------------------------------------------------
# input specs per (arch x shape) cell
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeConfig):
    """``(kind, specs)``: the step a cell runs and its batch as ``{name:
    (shape, dtype)}`` (the reference's ``ShapeDtypeStruct``s as plain
    shapes and ``torch`` dtypes).  ``kind`` is ``"train"`` (loss and
    gradients), ``"prefill"`` (forward and cache fill) or ``"decode"`` (one
    token)."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    i32, dt = torch.int32, getattr(torch, cfg.dtype)
    if kind in ("train", "prefill"):
        if cfg.family == "encdec":
            specs = {"frames": ((B, cfg.enc_seq, cfg.d_model), dt), "tokens": ((B, S), i32),
                     "labels": ((B, S), i32), "positions": ((B, S), i32)}
        elif cfg.family == "vlm":
            S_text = S - cfg.frontend_tokens
            specs = {"tokens": ((B, S_text), i32), "labels": ((B, S_text), i32),
                     "positions": ((B, S), i32),
                     "patch_embeds": ((B, cfg.frontend_tokens, cfg.d_model), dt)}
        else:
            specs = {"tokens": ((B, S), i32), "labels": ((B, S), i32),
                     "positions": ((B, S), i32)}
        return kind, specs
    if kind == "decode":
        return kind, {"token_ids": ((B,), i32)}
    raise ValueError(kind)


def runnable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not: the 500k-token
    decode needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k-context decode skipped"
    return True, ""

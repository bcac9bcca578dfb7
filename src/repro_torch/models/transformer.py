"""Dense decoder-only transformer: init, the training forward and loss, and
the serving steps (port of the dense family of ``repro.models.transformer``).

Parameters are a plain dict: ``embed``/``final_norm``/``lm_head`` as in the
JAX tree, ``layers`` a list of per-layer dicts (the JAX tree stacks them on
a leading L dim; ``convert.from_jax_params`` unstacks).  The layer loop is a
Python loop.  The training forward (:func:`lm_apply`) applies ``cfg.remat``
per block: ``"full"`` recomputes each block in the backward
(``torch.utils.checkpoint``, so kernel A runs twice per layer and step),
``"none"`` keeps its activations; ``"dots"`` is not ported.

Serve state is a dict of tensors laid out like the JAX pytree (K/V stacked
over layers).  The JAX steps return a new state; here each step updates the
state **in place** (the counterpart of the engine's donated buffers) and
returns ``(logits, state)`` with the same dict.  Every ``mode="drop"``
scatter of the JAX code goes through one drop plan per step, shared by all
layers (``serving.kv_cache.drop_plan``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ref import PAD_POS
from repro_torch.models.attention import (
    attention,
    attention_decode,
    attention_decode_paged,
    attention_init,
    attention_prefill_chunk,
    attention_prefill_chunk_paged,
)
from repro_torch.models.layers import (
    apply_norm,
    dense_init,
    embed_init,
    lm_cross_entropy,
    mlp,
    mlp_init,
    norm_init,
    torch_dtype,
)
from repro_torch.serving.kv_cache import (
    apply_drop,
    drop_plan,
    gather_positions,
    init_paged_cache,
    view_indices,
    write_coords,
)

__all__ = [
    "init_lm",
    "lm_apply",
    "lm_loss",
    "init_decode_cache",
    "init_paged_decode_cache",
    "lm_prefill_chunk",
    "lm_decode_step",
    "lm_prefill_chunk_paged",
    "lm_decode_step_paged",
]


def _layer_init(gen, cfg, device, training):
    return {
        "attn": attention_init(gen, cfg, device, training),
        "ln1": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype,
                         device=device),
        "ln2": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype,
                         device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, mlp_type=cfg.mlp_type,
                        dtype=cfg.param_dtype if training else cfg.dtype, device=device),
    }


def init_lm(cfg, gen: torch.Generator, device="cuda", training: bool = False):
    """Random parameters from ``gen`` (a generator on ``device``), with the
    JAX init's distributions.  ``training`` stores every leaf in
    ``cfg.param_dtype``, as the JAX tree; by default (serving) dense weights
    and the embedding table are stored in ``cfg.dtype`` and norms in
    ``cfg.param_dtype`` (see ``models.layers``)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    wdt = cfg.param_dtype if training else cfg.dtype
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=wdt, device=device),
        "layers": [_layer_init(gen, cfg, device, training) for _ in range(cfg.n_layers)],
        "final_norm": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype,
                                device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=wdt,
                                       device=device)
    return params


def _lm_head_w(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def _logits(params, x, cfg):
    dt = torch_dtype(cfg.dtype)
    return x.to(dt) @ _lm_head_w(params, cfg).to(dt)


def _embed(params, token_ids, cfg):
    return params["embed"]["table"][token_ids.long()].to(torch_dtype(cfg.dtype))


def _block(p_l, x, cfg, attend):
    """One pre-norm block; ``attend(p_attn, h)`` is its attention."""
    h = apply_norm(p_l["ln1"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    x = x + attend(p_l["attn"], h)
    h = apply_norm(p_l["ln2"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    return x + mlp(p_l["mlp"], h, mlp_type=cfg.mlp_type, compute_dtype=torch_dtype(cfg.dtype))


def _layers(params, x, cfg, attend):
    """Run every block; ``attend(l, p_attn, h)`` is the layer's attention."""
    for l, p_l in enumerate(params["layers"]):
        x = _block(p_l, x, cfg, lambda p, h, l=l: attend(l, p, h))
    return apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)


def lm_apply(params, tokens, positions, *, cfg, pctx):
    """Full forward, returns ``(hidden (B,S,d), aux)``; ``aux`` is the MoE
    router loss, 0 for the dense family."""
    if cfg.remat not in ("none", "full"):
        if cfg.remat == "dots":
            raise NotImplementedError("remat='dots' is not ported (no config uses it)")
        raise ValueError(f"unknown remat policy {cfg.remat!r}")

    def block(p_l, x):
        return _block(p_l, x, cfg, lambda p, h: attention(p, h, positions, cfg=cfg, pctx=pctx,
                                                          window=cfg.window))

    x = _embed(params, tokens, cfg)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for p_l in params["layers"]:
        x = checkpoint(block, p_l, x, use_reentrant=False) if remat else block(p_l, x)
    x = apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_loss(params, batch, *, cfg, pctx):
    """Causal LM loss; ``batch``: tokens/labels/positions (+mask) tensors.
    Returns ``(total, metrics)``."""
    x, aux = lm_apply(params, batch["tokens"], batch["positions"], cfg=cfg, pctx=pctx)
    dt = torch_dtype(cfg.dtype)
    loss, denom = lm_cross_entropy(x, _lm_head_w(params, cfg).to(dt), batch["labels"],
                                   mask=batch.get("mask"), chunk=cfg.logits_chunk,
                                   compute_dtype=dt)
    total = loss + cfg.router_aux_coef * aux / max(cfg.n_layers, 1)
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": denom}


def _last_valid(x, n_valid):
    """Each row's hidden state at its last valid chunk position."""
    B, C = x.shape[:2]
    idx = (n_valid.long() - 1).clamp(0, C - 1)
    return x[torch.arange(B, device=x.device), idx]


def init_decode_cache(cfg, batch: int, max_len: int, dtype=None, device="cuda"):
    """Dense serve state: K/V stacked over layers, positions at ``PAD_POS``."""
    dt = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, max_len), PAD_POS, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_paged_decode_cache(cfg, *, n_pages: int, page_size: int, max_batch: int,
                            slot_pages: int, dtype=None, device="cuda"):
    """Page-pool serve state (see ``serving.kv_cache.init_paged_cache``)."""
    return init_paged_cache(
        cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, n_pages=n_pages, page_size=page_size,
        max_batch=max_batch, slot_pages=slot_pages, dtype=torch_dtype(dtype or cfg.dtype),
        device=device,
    )


def _chunk_positions(length, n_valid, C):
    offs = torch.arange(C, dtype=torch.int32, device=length.device)[None, :]
    positions = length[:, None] + offs
    valid = offs < n_valid[:, None]
    return positions, valid


@torch.inference_mode()
def lm_prefill_chunk(params, token_ids, cache, n_valid, *, cfg, pctx):
    """Chunked prefill: append ``token_ids (B, C)`` to the per-request caches.

    ``n_valid (B,)`` real tokens per row (0 skips the row untouched).  Row
    ``b``'s valid tokens land in slots ``[len_b, len_b + n_valid_b)`` and
    attend to the resident cache of earlier chunks plus the chunk itself.
    Returns ``(logits (B, V), cache)``, logits at each row's last valid
    position.
    """
    B, C = token_ids.shape
    Smax = cache["pos"].shape[1]
    n_valid = n_valid.to(torch.int32)
    positions, valid = _chunk_positions(cache["len"], n_valid, C)
    write_index = torch.where(valid, positions, Smax)
    rows = torch.arange(B, device=token_ids.device)[:, None]
    plan = drop_plan((rows, write_index), (B, Smax))
    old_pos = cache["pos"]  # pre-chunk table: rewritten only after every layer

    def attend(l, p, h):
        return attention_prefill_chunk(p, h, positions, cache["k"][l], cache["v"][l],
                                       old_pos, plan, cfg=cfg, pctx=pctx, window=cfg.window)

    x = _layers(params, _embed(params, token_ids, cfg), cfg, attend)
    logits = _logits(params, _last_valid(x, n_valid), cfg)
    apply_drop(cache["pos"], plan, positions)
    cache["len"] += n_valid
    return logits, cache


@torch.inference_mode()
def lm_decode_step(params, token_ids, cache, active=None, *, cfg, pctx):
    """One decode step for every row: ``token_ids (B,)`` -> ``logits (B, V)``.

    New K/V are written at slot ``len[b]``; ``active (B,)`` (bool) skips rows
    entirely (no write, no length advance)."""
    B = token_ids.shape[0]
    Smax = cache["pos"].shape[1]
    length = cache["len"]
    if active is None:
        write_index = length.clone()
        new_len = length + 1
    else:
        write_index = torch.where(active, length, Smax)
        new_len = torch.where(active, length + 1, length)
    positions = length[:, None].clone()  # global position == length
    plan = drop_plan((torch.arange(B, device=token_ids.device), write_index), (B, Smax))
    apply_drop(cache["pos"], plan, positions[:, 0])  # includes the new token

    def attend(l, p, h):
        return attention_decode(p, h, positions, cache["k"][l], cache["v"][l], cache["pos"],
                                plan, cfg=cfg, pctx=pctx, window=cfg.window)

    x = _layers(params, _embed(params, token_ids[:, None], cfg), cfg, attend)
    logits = _logits(params, x, cfg)[:, 0]
    cache["len"].copy_(new_len)
    return logits, cache


@torch.inference_mode()
def lm_prefill_chunk_paged(params, token_ids, cache, n_valid, *, cfg, pctx):
    """Paged chunked prefill: the page-pool analog of :func:`lm_prefill_chunk`.

    Row ``b``'s valid tokens land in the pages its block table maps for
    logical slots ``[len_b, len_b + n_valid_b)``; unmapped entries drop the
    write.  The resident view is clamped to the pages the pre-chunk length
    uses, with positions from the pre-chunk pool.
    """
    B, C = token_ids.shape
    n_pages, page_size = cache["pos"].shape
    bt = cache["block_tables"]
    n_valid = n_valid.to(torch.int32)
    positions, valid = _chunk_positions(cache["len"], n_valid, C)
    write_page, write_off = write_coords(bt, positions, valid, n_pages, page_size)
    plan = drop_plan((write_page, write_off), (n_pages, page_size))
    flat_view = view_indices(bt, page_size, lengths=cache["len"])
    old_pos_view = gather_positions(cache["pos"], flat_view)

    def attend(l, p, h):
        return attention_prefill_chunk_paged(
            p, h, positions, cache["k"][l], cache["v"][l], old_pos_view, flat_view, plan,
            cfg=cfg, pctx=pctx, window=cfg.window,
        )

    x = _layers(params, _embed(params, token_ids, cfg), cfg, attend)
    logits = _logits(params, _last_valid(x, n_valid), cfg)
    apply_drop(cache["pos"], plan, positions)
    cache["len"] += n_valid
    return logits, cache


@torch.inference_mode()
def lm_decode_step_paged(params, token_ids, cache, active=None, *, cfg, pctx):
    """Paged decode step: the page-pool analog of :func:`lm_decode_step`.

    The new token's K/V land at the ``(page, offset)`` its block table maps
    for slot ``len[b]``; attention reads the pool through the block table
    (no dense view on the kernel path)."""
    B = token_ids.shape[0]
    n_pages, page_size = cache["pos"].shape
    bt = cache["block_tables"]
    length = cache["len"]
    if active is None:
        valid = torch.ones((B,), dtype=torch.bool, device=token_ids.device)
        new_len = length + 1
    else:
        valid = active
        new_len = torch.where(active, length + 1, length)
    write_page, write_off = write_coords(bt, length, valid, n_pages, page_size)
    positions = length[:, None].clone()
    plan = drop_plan((write_page, write_off), (n_pages, page_size))
    apply_drop(cache["pos"], plan, positions[:, 0])  # includes the new token

    def attend(l, p, h):
        return attention_decode_paged(
            p, h, positions, cache["k"][l], cache["v"][l], cache["pos"], bt, new_len, plan,
            cfg=cfg, pctx=pctx, window=cfg.window,
        )

    x = _layers(params, _embed(params, token_ids[:, None], cfg), cfg, attend)
    logits = _logits(params, x, cfg)[:, 0]
    cache["len"].copy_(new_len)
    return logits, cache

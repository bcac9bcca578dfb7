"""Decoder-only transformer: init, the training forward and loss, and the
serving steps (port of ``repro.models.transformer``) for the dense family,
the MoE family (``models.moe`` in place of the MLP, its router loss summed
over the layers into the training loss) and the VLM family (patch
embeddings prepended to the token stream, no loss over them).

Parameters are a plain dict: ``embed``/``final_norm``/``lm_head`` as in the
JAX tree, ``layers`` a list of per-layer dicts (the JAX tree stacks them on
a leading L dim; ``convert.from_jax_params`` unstacks).  The layer loop is a
Python loop.  The training forward (:func:`lm_apply`) applies ``cfg.remat``
per block: ``"full"`` recomputes each block in the backward
(``torch.utils.checkpoint``, so kernel A runs twice per layer and step),
``"none"`` keeps its activations, and ``"dots"`` (the counterpart of
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``) keeps the
outputs of the weight products and recomputes everything else, the flash
attention and the MoE experts' batched products included
(:func:`dots_policy`).

Serve state is a dict of tensors laid out like the JAX pytree (K/V stacked
over layers).  The JAX steps return a new state; here each step updates the
state **in place** (the counterpart of the engine's donated buffers) and
returns ``(logits, state)`` with the same dict.  Every ``mode="drop"``
scatter of the JAX code goes through one drop plan per step, shared by all
layers (``serving.kv_cache.drop_plan``).

With ``sp_degree > 1`` the serve state is sequence-sharded over the ring
in the layout ``serving.kv_cache`` describes (dense slab rank-major on the
virtual ring, page stripes on a process group); each step maps its global
writes and views into that layout, and the attention merges the ranks'
partials (``core/decode.py``).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

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
from repro_torch.models.moe import moe_ffn, moe_init
from repro_torch.serving.kv_cache import (
    apply_drop,
    dense_write_index,
    drop_plan,
    gather_positions,
    init_paged_cache,
    local_pages,
    sp_ranks,
    stripe_view,
    view_indices,
    write_coords,
)

# The families this module builds (``models.registry``).
FAMILIES = ("dense", "moe", "vlm")

__all__ = [
    "init_lm",
    "lm_apply",
    "lm_loss",
    "lm_prefill",
    "init_decode_cache",
    "init_paged_decode_cache",
    "lm_prefill_chunk",
    "lm_decode_step",
    "lm_prefill_chunk_paged",
    "lm_decode_step_paged",
    "dots_policy",
]

# The weight products of a block: ``x @ w`` of a (B, S, d) activation by a
# (d, d_out) weight reaches the dispatcher as one 2-D ``mm`` (``addmm`` with
# a bias), the MoE router's product and its shared expert's included;
# attention's products are batched (``bmm``) or inside the flash function,
# and so are the MoE experts' (``"becd,edf->becf"`` batches over the
# experts) and its gate-weighted combine: all are recomputed, as JAX's
# ``dots_with_no_batch_dims_saveable`` recomputes dots with batch dims.
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat ``"dots"``: save the outputs of
    the weight products, recompute every other op."""
    if op in _WEIGHT_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _layer_init(gen, cfg, device, training):
    p = {
        "attn": attention_init(gen, cfg, device, training),
        "ln1": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype,
                         device=device),
        "ln2": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype,
                         device=device),
    }
    if cfg.n_experts:
        p["moe"] = moe_init(gen, cfg, device, training)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, mlp_type=cfg.mlp_type,
                            dtype=cfg.param_dtype if training else cfg.dtype, device=device)
    return p


def init_lm(cfg, gen: torch.Generator, device="cuda", training: bool = False):
    """Random parameters from ``gen`` (a generator on ``device``), with the
    JAX init's distributions.  ``training`` stores every leaf in
    ``cfg.param_dtype``, as the JAX tree; by default (serving) dense weights
    and the embedding table are stored in ``cfg.dtype`` and norms in
    ``cfg.param_dtype`` (see ``models.layers``; the MoE router always in
    ``cfg.param_dtype``, see ``models.moe``)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not a transformer family")
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


def _embed(params, token_ids, cfg, prefix_embeds=None):
    """Token embeddings in ``cfg.dtype``; a VLM's patch embeddings
    ``prefix_embeds (B, n_img, d)`` occupy the first slots."""
    x = params["embed"]["table"][token_ids.long()].to(torch_dtype(cfg.dtype))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _block(p_l, x, cfg, attend, pctx, sharded=False):
    """One pre-norm block; ``attend(p_attn, h)`` is its attention.  Returns
    ``(x, aux)``: the MoE router loss of the layer, ``None`` for an MLP
    (``sharded``: ``x`` is this rank's sequence shard, ``models.moe``)."""
    h = apply_norm(p_l["ln1"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    x = x + attend(p_l["attn"], h)
    h = apply_norm(p_l["ln2"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    if cfg.n_experts:
        y, aux = moe_ffn(p_l["moe"], h, cfg, pctx, sharded=sharded)
        return x + y, aux
    return x + mlp(p_l["mlp"], h, mlp_type=cfg.mlp_type,
                   compute_dtype=torch_dtype(cfg.dtype)), None


def _layers(params, x, cfg, attend, pctx):
    """Run every block of a serving step; ``attend(l, p_attn, h)`` is the
    layer's attention."""
    for l, p_l in enumerate(params["layers"]):
        x, _ = _block(p_l, x, cfg, lambda p, h, l=l: attend(l, p, h), pctx)
    return apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)


def lm_apply(params, tokens, positions, *, cfg, pctx, prefix_embeds=None):
    """Full forward, returns ``(hidden (B,S,d), aux)``; ``aux`` is the MoE
    router loss summed over the layers, 0 for the other families."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    sharded = pctx.active and not pctx.ring.folded

    def block(p_l, x):
        return _block(p_l, x, cfg, lambda p, h: attention(p, h, positions, cfg=cfg, pctx=pctx,
                                                          window=cfg.window),
                      pctx, sharded)

    x = _embed(params, tokens, cfg, prefix_embeds)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    kw = {"context_fn": functools.partial(create_selective_checkpoint_contexts, dots_policy)
          } if cfg.remat == "dots" else {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_l in params["layers"]:
        x, a = checkpoint(block, p_l, x, use_reentrant=False, **kw) if remat else block(p_l, x)
        if a is not None:
            aux = aux + a
    x = apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    return x, aux


def lm_loss(params, batch, *, cfg, pctx):
    """Causal LM loss; ``batch``: tokens/labels/positions (+mask,
    +patch_embeds) tensors; ``positions`` cover the image prefix too, which
    carries no loss.  Returns ``(total, metrics)``: the CE plus
    ``router_aux_coef * aux / n_layers``."""
    patches = batch.get("patch_embeds")
    x, aux = lm_apply(params, batch["tokens"], batch["positions"], cfg=cfg, pctx=pctx,
                      prefix_embeds=patches)
    labels, mask = batch["labels"], batch.get("mask")
    if patches is not None:
        B, n_img = labels.shape[0], patches.shape[1]
        labels = torch.cat([labels.new_zeros((B, n_img)), labels], dim=1)
        text = torch.ones(batch["labels"].shape, dtype=torch.float32, device=labels.device)
        mask = torch.cat([torch.zeros((B, n_img), dtype=torch.float32, device=labels.device),
                          text if mask is None else mask], dim=1)
    dt = torch_dtype(cfg.dtype)
    loss, denom = lm_cross_entropy(x, _lm_head_w(params, cfg).to(dt), labels, mask=mask,
                                   chunk=cfg.logits_chunk, compute_dtype=dt)
    total = loss + cfg.router_aux_coef * aux / max(cfg.n_layers, 1)
    return total, {"ce_loss": loss, "aux_loss": aux, "tokens": denom}


def _last_valid(x, n_valid):
    """Each row's hidden state at its last valid chunk position."""
    B, C = x.shape[:2]
    idx = (n_valid.long() - 1).clamp(0, C - 1)
    return x[torch.arange(B, device=x.device), idx]


@torch.inference_mode()
def lm_prefill(params, tokens, positions, cache, prefix_embeds=None, *, cfg, pctx):
    """One-shot prefill into the dense slab: the whole sequence (a VLM's
    ``prefix_embeds (B, n_img, d)`` first, then ``tokens (B, S_text)``) at
    ``positions (B, S)`` fills slots ``[0, S)`` of every row, and every
    row's length becomes ``S``.  Returns ``(logits (B, V), cache)``, the
    logits at the last position.  At SP 1 only."""
    if pctx.active:
        raise NotImplementedError(
            "lm_prefill at sp_degree > 1 is not ported yet (ROADMAP queue 1 item 9c); "
            "prefill through the chunked path")
    x = _embed(params, tokens, cfg, prefix_embeds)
    B, S = x.shape[:2]
    positions = positions.to(torch.int32)
    slots = torch.arange(S, device=x.device)[None, :]
    plan = _dense_plan(cache, torch.arange(B, device=x.device)[:, None], slots, pctx)

    def attend(l, p, h):
        return attention(p, h, positions, cfg=cfg, pctx=pctx, window=cfg.window,
                         cache={"k": cache["k"][l], "v": cache["v"][l], "plan": plan})

    x = _layers(params, x, cfg, attend, pctx)
    logits = _logits(params, x[:, -1], cfg)
    apply_drop(cache["pos"], plan, positions)
    cache["len"].fill_(S)
    return logits, cache


def init_decode_cache(cfg, batch: int, max_len: int, dtype=None, device="cuda", pctx=None):
    """Dense serve state: K/V stacked over layers, positions at ``PAD_POS``.
    With an active ``pctx`` the slots shard over the ring (``max_len`` a
    multiple of the SP degree): ``(L, P*B, max_len/P, ...)`` rank-major on the
    virtual ring, this rank's ``(L, B, max_len/P, ...)`` on a process group."""
    P, rank = sp_ranks(pctx)
    if max_len % P:
        raise ValueError(f"dense cache: max_len={max_len} must be a multiple of the SP "
                         f"degree {P} so slots shard evenly across the ring")
    rows = batch * P if rank is None else batch
    dt = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, rows, max_len // P, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((rows, max_len // P), PAD_POS, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_paged_decode_cache(cfg, *, n_pages: int, page_size: int, max_batch: int,
                            slot_pages: int, dtype=None, device="cuda", pctx=None):
    """Page-pool serve state (see ``serving.kv_cache.init_paged_cache``)."""
    return init_paged_cache(
        cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, n_pages=n_pages, page_size=page_size,
        max_batch=max_batch, slot_pages=slot_pages, dtype=torch_dtype(dtype or cfg.dtype),
        device=device, pctx=pctx,
    )


def _chunk_positions(length, n_valid, C):
    offs = torch.arange(C, dtype=torch.int32, device=length.device)[None, :]
    positions = length[:, None] + offs
    valid = offs < n_valid[:, None]
    return positions, valid


def _dense_plan(cache, rows, slots, pctx):
    """Drop plan of writes at global ``(row, slot)`` into the dense slab as
    this process holds it."""
    P, rank = sp_ranks(pctx)
    s_loc = cache["pos"].shape[1]
    index, bounds = dense_write_index(rows, slots, batch=cache["len"].shape[0], s_loc=s_loc,
                                      P=P, rank=rank)
    return drop_plan(index, bounds)


def _pool_pages(cache, pctx):
    """``(global pages, page size)`` of a page pool; a process group holds
    only its stripe of them."""
    P, rank = sp_ranks(pctx)
    held, page_size = cache["pos"].shape
    return (held if rank is None else held * P), page_size


def _paged_plan(cache, page, off, pctx):
    """Drop plan of writes at global ``(page, offset)`` into the pool this
    process holds."""
    P, rank = sp_ranks(pctx)
    n_pages, page_size = _pool_pages(cache, pctx)
    return drop_plan((local_pages(page, n_pages, P, rank), off),
                     tuple(cache["pos"].shape))


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
    Smax = cache["pos"].shape[1] * sp_ranks(pctx)[0]
    n_valid = n_valid.to(torch.int32)
    positions, valid = _chunk_positions(cache["len"], n_valid, C)
    write_index = torch.where(valid, positions, Smax)
    rows = torch.arange(B, device=token_ids.device)[:, None]
    plan = _dense_plan(cache, rows, write_index, pctx)
    old_pos = cache["pos"]  # pre-chunk table: rewritten only after every layer

    def attend(l, p, h):
        return attention_prefill_chunk(p, h, positions, cache["k"][l], cache["v"][l],
                                       old_pos, plan, cfg=cfg, pctx=pctx, window=cfg.window)

    x = _layers(params, _embed(params, token_ids, cfg), cfg, attend, pctx)
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
    Smax = cache["pos"].shape[1] * sp_ranks(pctx)[0]
    length = cache["len"]
    if active is None:
        write_index = length.clone()
        new_len = length + 1
    else:
        write_index = torch.where(active, length, Smax)
        new_len = torch.where(active, length + 1, length)
    positions = length[:, None].clone()  # global position == length
    plan = _dense_plan(cache, torch.arange(B, device=token_ids.device), write_index, pctx)
    apply_drop(cache["pos"], plan, positions[:, 0])  # includes the new token

    def attend(l, p, h):
        return attention_decode(p, h, positions, cache["k"][l], cache["v"][l], cache["pos"],
                                plan, cfg=cfg, pctx=pctx, window=cfg.window)

    x = _layers(params, _embed(params, token_ids[:, None], cfg), cfg, attend, pctx)
    logits = _logits(params, x, cfg)[:, 0]
    cache["len"].copy_(new_len)
    return logits, cache


@torch.inference_mode()
def lm_prefill_chunk_paged(params, token_ids, cache, n_valid, *, cfg, pctx):
    """Paged chunked prefill: the page-pool analog of :func:`lm_prefill_chunk`.

    Row ``b``'s valid tokens land in the pages its block table maps for
    logical slots ``[len_b, len_b + n_valid_b)``; unmapped entries drop the
    write.  The resident view is clamped to the pages the pre-chunk length
    uses, with positions from the pre-chunk pool; with ``sp_degree > 1``
    each rank's view holds its own pages only (``kv_cache.stripe_view``).
    """
    B, C = token_ids.shape
    P, rank = sp_ranks(pctx)
    n_pages, page_size = _pool_pages(cache, pctx)
    bt = cache["block_tables"]
    n_valid = n_valid.to(torch.int32)
    positions, valid = _chunk_positions(cache["len"], n_valid, C)
    write_page, write_off = write_coords(bt, positions, valid, n_pages, page_size)
    plan = _paged_plan(cache, write_page, write_off, pctx)
    flat_view = stripe_view(view_indices(bt, page_size, lengths=cache["len"]), n_pages,
                            page_size, P, rank)
    old_pos_view = gather_positions(cache["pos"], flat_view)

    def attend(l, p, h):
        return attention_prefill_chunk_paged(
            p, h, positions, cache["k"][l], cache["v"][l], old_pos_view, flat_view, plan,
            cfg=cfg, pctx=pctx, window=cfg.window, table_pages=bt.shape[1],
        )

    x = _layers(params, _embed(params, token_ids, cfg), cfg, attend, pctx)
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
    n_pages, page_size = _pool_pages(cache, pctx)
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
    plan = _paged_plan(cache, write_page, write_off, pctx)
    apply_drop(cache["pos"], plan, positions[:, 0])  # includes the new token

    def attend(l, p, h):
        return attention_decode_paged(
            p, h, positions, cache["k"][l], cache["v"][l], cache["pos"], bt, new_len, plan,
            cfg=cfg, pctx=pctx, window=cfg.window, table_pages=bt.shape[1],
        )

    x = _layers(params, _embed(params, token_ids[:, None], cfg), cfg, attend, pctx)
    logits = _logits(params, x, cfg)[:, 0]
    cache["len"].copy_(new_len)
    return logits, cache

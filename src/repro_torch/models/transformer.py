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

:func:`lm_decode_step` also takes parameters in serve storage
(``sharding.shard_tree`` of a ``mode="serve"`` layout: the reference's
Megatron layout, which its dry run compiles the decode step under): it
binds their :class:`~repro_torch.sharding.ServeBlocks` leaves to the
context's mesh transport, and each layer computes on its blocks with the
tensor-parallel collectives of ``models/layers.py``.  q, k and v come out
of their column blocks gathered, since the cache is sharded by sequence,
not by head, and every rank reads every head; the output projection and
the MLP's down projection end in a sum all-reduce; the head's logits are
gathered (or summed) whole before they are returned.  The cache keeps
its SP layout, which ``sharding.serve_state_shardings`` describes.
:func:`serve_comm_bytes` is the closed form of such a step's bytes a
rank and direction, per link class.
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
    dense,
    dense_init,
    embed_init,
    embed_lookup,
    lm_cross_entropy,
    mlp,
    mlp_init,
    norm_init,
    torch_dtype,
    TPBytes,
    comm_classes,
)
from repro_torch.models.moe import ep_size, moe_ffn, moe_init
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
from repro_torch.sharding import bind_serve, layer_params

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
    "serve_comm_bytes",
    "decode_link_bytes",
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
    return dense({"w": _lm_head_w(params, cfg)}, x, torch_dtype(cfg.dtype))


def _embed(params, token_ids, cfg, prefix_embeds=None):
    """Token embeddings in ``cfg.dtype``; a VLM's patch embeddings
    ``prefix_embeds (B, n_img, d)`` occupy the first slots."""
    x = embed_lookup(params["embed"]["table"], token_ids.long()).to(torch_dtype(cfg.dtype))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _embed_rows(params, token_ids, cfg, prefix_embeds, lo: int, hi: int):
    """Rows ``[lo, hi)`` of :func:`_embed`'s sequence (the image's
    ``n_img`` slots, then the text): a rank of a process group holds the
    whole text and image (``sharding.batch_block``) and embeds only its own
    sequence shard."""
    n_img = prefix_embeds.shape[1]
    text = token_ids[:, max(lo - n_img, 0):max(hi - n_img, 0)]
    x = embed_lookup(params["embed"]["table"], text.long()).to(torch_dtype(cfg.dtype))
    return torch.cat([prefix_embeds[:, min(lo, n_img):min(hi, n_img)].to(x.dtype), x], dim=1)


def _own_rows(pctx, positions) -> tuple[int, int]:
    """``[lo, hi)``: the rows of the sequence this rank of a process group
    holds, its contiguous shard of the (layout-ordered) batch."""
    n = positions.shape[1]
    rank = sp_ranks(pctx)[1]
    return rank * n, (rank + 1) * n


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


def _layers(params, x, cfg, attend, pctx, sharded=False):
    """Run every block of a serving step; ``attend(l, p_attn, h)`` is the
    layer's attention (``sharded``: ``x`` is this rank's sequence shard).  A
    layer of FSDP blocks (a prefill on training storage) is gathered just
    before its block."""
    for l, p_l in enumerate(params["layers"]):
        x, _ = _block(layer_params(p_l), x, cfg, lambda p, h, l=l: attend(l, p, h), pctx,
                      sharded)
    return apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)


def lm_apply(params, tokens, positions, *, cfg, pctx, prefix_embeds=None):
    """Full forward, returns ``(hidden (B,S,d), aux)``; ``aux`` is the MoE
    router loss summed over the layers, 0 for the other families.  A layer
    of FSDP blocks (``sharding.LayerBlocks``) is gathered as the first step
    of its block, inside the remat region."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    sharded = pctx.active and not pctx.ring.folded

    def block(p_l, x):
        return _block(layer_params(p_l), x, cfg,
                      lambda p, h: attention(p, h, positions, cfg=cfg, pctx=pctx,
                                             window=cfg.window),
                      pctx, sharded)

    if sharded and prefix_embeds is not None:
        x = _embed_rows(params, tokens, cfg, prefix_embeds, *_own_rows(pctx, positions))
    else:
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
        if pctx.active and not pctx.ring.folded:  # this rank's rows (_embed_rows)
            lo, hi = _own_rows(pctx, batch["positions"])
            labels, mask = labels[:, lo:hi], mask[:, lo:hi]
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
    ``positions (B, S)`` fills global slots ``[0, S)`` of every row, and
    every row's length becomes ``S``.  Returns ``(logits (B, V), cache)``,
    the logits at the last position.

    The inputs are replicated, as every serving step's query side is.  With
    ``sp_degree > 1`` attention runs ``sp_attention`` under the context's
    strategy and the K/V land in the slab's SP layout (``_dense_plan``), so
    ``sp_decode`` reads them as they are: on the virtual ring the sequence
    stays global; on a process group each rank runs its contiguous shard of
    it (``S`` a multiple of the SP degree), all-gathers every layer's K/V to
    write the slots it holds, and takes the last position's hidden state
    from the last rank."""
    x = _embed(params, tokens, cfg, prefix_embeds)
    B, S = x.shape[:2]
    positions = positions.to(torch.int32)
    slots = torch.arange(S, device=x.device)[None, :]
    plan = _dense_plan(cache, torch.arange(B, device=x.device)[:, None], slots, pctx)
    P, rank = sp_ranks(pctx)
    sharded = rank is not None
    pos_seq = positions
    if sharded:
        if S % P:
            raise ValueError(f"prefill of {S} positions does not shard over {P} ranks")
        own = slice(rank * (S // P), (rank + 1) * (S // P))
        x, pos_seq = x[:, own], positions[:, own]

    def attend(l, p, h):
        return attention(p, h, pos_seq, cfg=cfg, pctx=pctx, window=cfg.window,
                         cache={"k": cache["k"][l], "v": cache["v"][l], "plan": plan})

    x = _layers(params, x, cfg, attend, pctx, sharded=sharded)
    last = pctx.ring.all_gather(x[:, -1:], 1)[:, -1] if sharded else x[:, -1]
    logits = _logits(params, last, cfg)
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
    entirely (no write, no length advance).  ``params`` may be in serve
    storage (module docstring)."""
    if pctx.storage is not None:
        bind_serve(params, pctx.storage)
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


def decode_link_bytes(cfg, rows: int, mesh) -> float:
    """One SP decode merge's ``"link"`` bytes a rank and direction
    (``core.decode.decode_comm_cost``): one attention layer's read of a
    cache sequence-sharded over the mesh's sequence axes."""
    from repro_torch.core.decode import decode_comm_cost

    P = mesh.shape["model"] * mesh.shape.get("pod", 1)
    return decode_comm_cost(rows, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, P).fwd_bytes


def serve_comm_bytes(layout, cfg, batch: int) -> dict[str, dict[str, float]]:
    """One :func:`lm_decode_step`'s bytes a rank and direction, by link
    class, on parameters in the serve layout ``layout``
    (``sharding.layout_for(..., mode="serve")``), ``batch`` the rows one
    rank's step carries (its data rank's).  With ``G`` the model size and
    ``n`` a tensor's bytes whole:

    * ``"tp"``: each product with a column-split weight all-gathers its
      output (``(G-1) * n/G / 2``), with a row-split one all-reduces it
      (``(G-1)/G * n``), and a split 1-D leaf a layer needs whole is
      all-gathered (a norm scale, a row projection's bias; a column
      projection's bias is added to its slice); a column/row pair of the
      MLP (``layers.tp_pair``) moves only its all-reduce; the embedding
      all-gathers its rows (split by ``d``) or all-reduces them (by
      vocabulary); the head's logits come whole the same way.  Products
      run in ``cfg.dtype``, the MoE router in float32
      (``layers.TPBytes``);
    * ``"link"``: the SP decode merge of every layer (:func:`decode_link_bytes`)
      and an MoE layer's expert-parallel sum of its float32 output over
      every SP rank;
    * ``"intra"``: that sum where the experts shard over ``model`` alone on
      the pod mesh (``moe.ep_size``): within each pod, on the inner ring;
    * ``"data"``: nothing: serve storage replicates every leaf over the
      data axis."""
    mesh = layout.mesh
    G, pods = mesh.shape["model"], mesh.shape.get("pod", 1)
    tb = TPBytes(mesh, batch, torch_dtype(cfg.dtype).itemsize)
    tp = tb.embed(layout.specs["embed"]["table"], layout.meta["embed"]["table"])
    link = intra = 0.0
    for specs, meta in zip(layout.specs["layers"], layout.meta["layers"]):
        tp += tb.norm(specs["ln1"], meta["ln1"]) + tb.norm(specs["ln2"], meta["ln2"])
        tp += tb.attention(specs["attn"], meta["attn"], cfg)
        link += decode_link_bytes(cfg, batch, mesh)
        if "moe" in specs:
            m, mm = specs["moe"], meta["moe"]
            tp += tb.product(m["router"], mm["router"], cfg.n_experts * 4)
            if "shared" in m:
                tp += tb.ffn(m["shared"], mm["shared"], cfg.d_model,
                             cfg.moe_d_ff * cfg.n_shared_experts)
            n_ep = ep_size(cfg.n_experts, G * pods, pods)
            ep_sum = (n_ep - 1) / n_ep * batch * cfg.d_model * 4
            if n_ep == G * pods:
                link += ep_sum
            else:
                intra += ep_sum
        else:
            tp += tb.ffn(specs["mlp"], meta["mlp"], cfg.d_model, cfg.d_ff)
    tp += tb.norm(layout.specs["final_norm"], layout.meta["final_norm"]) + tb.head(layout, cfg)
    return comm_classes(tp, link, intra)


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

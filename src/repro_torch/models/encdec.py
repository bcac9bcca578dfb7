"""Encoder-decoder backbone, whisper-base (port of ``repro.models.encdec``).

The audio frontend (mel conv stack) is a stub, as in the JAX package: the
batch carries precomputed frame embeddings ``frames (B, S_enc, d)`` and the
encoder adds sinusoidal positions.  The encoder is non-causal with no RoPE;
the decoder has learned positions (``dec_pos``), causal self-attention and,
in every layer, cross-attention against the encoder's K/V
(``models.attention.cross_attention``): TokenRing's natural fit, since the
decoder's queries circulate and the sequence-sharded encoder never moves.
The tied embedding is the output head.

Parameters are a plain dict: ``embed``, ``dec_pos``, ``enc_norm`` and
``dec_norm`` as in the JAX tree, ``enc_layers`` and ``dec_layers`` lists of
per-layer dicts (the JAX tree stacks them; ``convert.from_jax_params``
unstacks).  Remat: any policy but ``"none"`` recomputes each layer whole in
the backward, as the JAX code checkpoints each layer with
``nothing_saveable`` whatever the policy's name.

On the virtual ring the model takes global tensors; on a process group
each rank passes its contiguous shard of the frames and of the decoder
tokens, and the sinusoids and default encoder positions follow the
shard's global rows.

Serving (:func:`encdec_encode`, :func:`encdec_decode_step`) keeps the dense
self-attention slab of ``transformer.init_decode_cache`` plus the cross
K/V of every decoder layer (``xk``/``xv``) and their positions
(``enc_pos``), in the ring's layout with ``sp_degree > 1`` (rank-major
``(P*B, S/P, ...)`` on the virtual ring, the rank's shard on a process
group).  The steps update the state in place and return it.  The decode
step's cross read is non-causal: every encoder frame is visible to every
decoder position, as in training.  The JAX decode step reads it causally,
a fault of the reference that the port does not copy (ROADMAP queue 3
item 9).

:func:`encdec_decode_step` also takes parameters in serve storage (the
reference's Megatron layout, ``sharding.shard_tree`` of a ``mode="serve"``
layout): the self and cross attention, the norms and the MLP run on their
blocks (``models.layers``), the token and learned-position lookups follow
their tables' split, and the tied head is a product with the table's
transposed blocks.  The caches keep their sequence-sharded layout.
:func:`encdec_serve_comm_bytes` is the closed form of the step's bytes on
serve storage.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import fold_ranks
from repro_torch.models.attention import (
    attention,
    attention_decode,
    attention_init,
    cross_attention,
    encode_kv,
)
from repro_torch.models.layers import (
    TPBytes,
    apply_norm,
    comm_classes,
    dense,
    embed_init,
    embed_lookup,
    lm_cross_entropy,
    mlp,
    mlp_init,
    norm_init,
    torch_dtype,
)
from repro_torch.models.transformer import _dense_plan, decode_link_bytes, init_decode_cache
from repro_torch.serving.kv_cache import apply_drop, sp_ranks
from repro_torch.sharding import bind_serve, layer_params

__all__ = [
    "init_encdec",
    "encdec_loss",
    "encdec_encode",
    "encdec_decode_step",
    "encdec_serve_comm_bytes",
    "init_encdec_state",
    "sinusoid_positions",
]


@functools.lru_cache(maxsize=8)
def _sinusoid_table(S: int, d: int, device: torch.device) -> torch.Tensor:
    pos = np.arange(S)[:, None]
    dim = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * dim / d)
    table = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def sinusoid_positions(S: int, d: int, device="cpu"):
    """``(S, d)`` float32 sinusoids: sines then cosines of ``pos /
    10000^(2i/d)``, computed in float64 as the JAX package does.  The table
    is made once per shape and device and shared: callers must not write
    to it."""
    return _sinusoid_table(S, d, torch.device(device))


def _norm(p, x, cfg):
    return apply_norm(p, x, norm_type=cfg.norm_type, eps=cfg.norm_eps)


def _norm_init(cfg, device):
    return norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype, device=device)


def _mlp_init(gen, cfg, device, wdt):
    return mlp_init(gen, cfg.d_model, cfg.d_ff, mlp_type=cfg.mlp_type, dtype=wdt, device=device)


def _enc_layer_init(gen, cfg, device, training):
    wdt = cfg.param_dtype if training else cfg.dtype
    return {"ln1": _norm_init(cfg, device), "attn": attention_init(gen, cfg, device, training),
            "ln2": _norm_init(cfg, device), "mlp": _mlp_init(gen, cfg, device, wdt)}


def _dec_layer_init(gen, cfg, device, training):
    wdt = cfg.param_dtype if training else cfg.dtype
    return {"ln1": _norm_init(cfg, device), "self": attention_init(gen, cfg, device, training),
            "ln_x": _norm_init(cfg, device), "cross": attention_init(gen, cfg, device, training),
            "ln2": _norm_init(cfg, device), "mlp": _mlp_init(gen, cfg, device, wdt)}


def init_encdec(cfg, gen: torch.Generator, device="cuda", training: bool = False,
                max_dec_len: int = 32768):
    """Random parameters from ``gen`` (a generator on ``device``) with the
    JAX init's distributions, in the storage layout of ``models.layers``
    (``training``: every leaf in ``cfg.param_dtype``; serving: dense
    weights, the embedding and ``dec_pos`` in ``cfg.dtype``)."""
    wdt = cfg.param_dtype if training else cfg.dtype
    dec_pos = torch.randn((max_dec_len, cfg.d_model), generator=gen, device=device,
                          dtype=torch.float32) * 0.01
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=wdt, device=device),
        "dec_pos": dec_pos.to(torch_dtype(wdt)),
        "enc_layers": [_enc_layer_init(gen, cfg, device, training)
                       for _ in range(cfg.n_enc_layers)],
        "dec_layers": [_dec_layer_init(gen, cfg, device, training)
                       for _ in range(cfg.n_layers)],
        "enc_norm": _norm_init(cfg, device),
        "dec_norm": _norm_init(cfg, device),
    }


def _first_row(S: int, pctx) -> int:
    """Global index of this process's first encoder frame: 0 where it holds
    the whole sequence, ``rank * S`` for a process group's shard."""
    rank = sp_ranks(pctx)[1]
    return 0 if rank is None else rank * S


def _enc_positions(B: int, S: int, pctx, device):
    start = _first_row(S, pctx)
    pos = torch.arange(start, start + S, dtype=torch.int32, device=device)
    return pos.expand(B, S).contiguous()


def _layer_loop(layers, x, body, cfg, *extra):
    """``x = body(p_l, x, *extra)`` over the layers; with remat each layer
    is recomputed whole in the backward.  A layer of FSDP blocks
    (``sharding.LayerBlocks``) is gathered first, inside the remat region."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    remat = cfg.remat != "none" and torch.is_grad_enabled()

    def layer(p_l, x, *extra):
        return body(layer_params(p_l), x, *extra)

    for p_l in layers:
        x = (checkpoint(layer, p_l, x, *extra, use_reentrant=False) if remat
             else layer(p_l, x, *extra))
    return x


def _encoder(params, frames, enc_pos, *, cfg, pctx):
    """``frames (B, S_enc, d)`` from the frontend stub -> encoder states."""
    dt = torch_dtype(cfg.dtype)
    S = frames.shape[1]
    start = _first_row(S, pctx)
    sin = sinusoid_positions(start + S, cfg.d_model, frames.device)[start:]
    x = frames.to(dt) + sin.to(dt)[None]

    def body(p_l, x):
        h = _norm(p_l["ln1"], x, cfg)
        x = x + attention(p_l["attn"], h, enc_pos, cfg=cfg, pctx=pctx, causal=False,
                          rope=False)
        h = _norm(p_l["ln2"], x, cfg)
        return x + mlp(p_l["mlp"], h, mlp_type=cfg.mlp_type, compute_dtype=dt)

    x = _layer_loop(params["enc_layers"], x, body, cfg)
    return _norm(params["enc_norm"], x, cfg)


def _embed(params, tokens, positions, cfg):
    """Token embeddings plus learned positions, in ``cfg.dtype``.  Positions
    past the table clamp to its last row, as JAX's gather does (a slot the
    engine leaves idle keeps advancing its length)."""
    dt = torch_dtype(cfg.dtype)
    table = params["dec_pos"]
    rows = positions.long().clamp(max=table.shape[0] - 1)
    return (embed_lookup(params["embed"]["table"], tokens.long()).to(dt)
            + embed_lookup(table, rows).to(dt))


def _decoder(params, tokens, positions, enc_x, enc_pos, *, cfg, pctx):
    dt = torch_dtype(cfg.dtype)
    x = _embed(params, tokens, positions, cfg)

    def body(p_l, x, enc_x):
        h = _norm(p_l["ln1"], x, cfg)
        x = x + attention(p_l["self"], h, positions, cfg=cfg, pctx=pctx, causal=True,
                          rope=False)
        h = _norm(p_l["ln_x"], x, cfg)
        ek, ev = encode_kv(p_l["cross"], enc_x, cfg)
        x = x + cross_attention(p_l["cross"], h, ek, ev, enc_pos, positions, cfg=cfg,
                                pctx=pctx)
        h = _norm(p_l["ln2"], x, cfg)
        return x + mlp(p_l["mlp"], h, mlp_type=cfg.mlp_type, compute_dtype=dt)

    x = _layer_loop(params["dec_layers"], x, body, cfg, enc_x)
    return _norm(params["dec_norm"], x, cfg)


def encdec_loss(params, batch, *, cfg, pctx):
    """``batch``: ``frames (B, S_enc, d)``, ``tokens``/``labels``/``positions
    (B, S_dec)`` (+``mask``, +``enc_positions``).  Returns ``(loss,
    metrics)``: the CE under the tied head."""
    frames = batch["frames"]
    B, S_enc = frames.shape[:2]
    enc_pos = batch.get("enc_positions")
    if enc_pos is None:
        enc_pos = _enc_positions(B, S_enc, pctx, frames.device)
    enc_x = _encoder(params, frames, enc_pos, cfg=cfg, pctx=pctx)
    x = _decoder(params, batch["tokens"], batch["positions"], enc_x, enc_pos, cfg=cfg,
                 pctx=pctx)
    dt = torch_dtype(cfg.dtype)
    loss, denom = lm_cross_entropy(x, params["embed"]["table"].T.to(dt), batch["labels"],
                                   mask=batch.get("mask"), chunk=cfg.logits_chunk,
                                   compute_dtype=dt)
    return loss, {"ce_loss": loss, "tokens": denom}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_encdec_state(cfg, batch: int, max_len: int, enc_seq: int, device="cuda", pctx=None):
    """Serve state: the dense self-attention slab of
    ``transformer.init_decode_cache`` plus the cross K/V ``xk``/``xv (L,
    rows, enc_seq/P, Hkv, D)`` and ``enc_pos (rows, enc_seq/P)``, all zero
    until :func:`encdec_encode` fills them, in the ring's layout."""
    P, rank = sp_ranks(pctx)
    if enc_seq % P:
        raise ValueError(f"enc_seq={enc_seq} must be a multiple of the SP degree {P} so "
                         "encoder frames shard evenly across the ring")
    state = init_decode_cache(cfg, batch, max_len, device=device, pctx=pctx)
    rows = batch * P if rank is None else batch
    shape = (cfg.n_layers, rows, enc_seq // P, cfg.n_kv_heads, cfg.head_dim)
    dt = state["k"].dtype
    state["xk"] = torch.zeros(shape, dtype=dt, device=device)
    state["xv"] = torch.zeros(shape, dtype=dt, device=device)
    state["enc_pos"] = torch.zeros((rows, enc_seq // P), dtype=torch.int32, device=device)
    return state


@torch.inference_mode()
def encdec_encode(params, frames, state, *, cfg, pctx):
    """Run the encoder once over ``frames (B, S_enc, d)`` (global on the
    virtual ring, this rank's shard on a process group) and write every
    decoder layer's cross K/V and the encoder positions into ``state``, in
    its layout.  Returns ``state``."""
    B, S_enc = frames.shape[:2]
    enc_pos = _enc_positions(B, S_enc, pctx, frames.device)
    enc_x = _encoder(params, frames, enc_pos, cfg=cfg, pctx=pctx)
    P, rank = sp_ranks(pctx)

    def layout(t):
        return fold_ranks(t, P) if rank is None and P > 1 else t

    for l, p_l in enumerate(params["dec_layers"]):
        k, v = encode_kv(p_l["cross"], enc_x, cfg)
        state["xk"][l].copy_(layout(k))
        state["xv"][l].copy_(layout(v))
    state["enc_pos"].copy_(layout(enc_pos))
    return state


@torch.inference_mode()
def encdec_decode_step(params, token_ids, state, *, cfg, pctx):
    """One decode step for every row: ``token_ids (B,)`` -> ``logits (B,
    V)``.  The new self K/V land at slot ``len[b]`` (dropped past the slab),
    every row's length advances; the cross read is non-causal.  ``params``
    may be in serve storage (module docstring)."""
    if pctx.storage is not None:
        bind_serve(params, pctx.storage)
    B = token_ids.shape[0]
    length = state["len"]
    positions = length[:, None].clone()  # global position == length
    plan = _dense_plan(state, torch.arange(B, device=token_ids.device), length.clone(), pctx)
    apply_drop(state["pos"], plan, positions[:, 0])  # includes the new token
    x = _embed(params, token_ids[:, None], positions, cfg)
    dt = torch_dtype(cfg.dtype)
    for l, p_l in enumerate(params["dec_layers"]):
        h = _norm(p_l["ln1"], x, cfg)
        x = x + attention_decode(p_l["self"], h, positions, state["k"][l], state["v"][l],
                                 state["pos"], plan, cfg=cfg, pctx=pctx, rope=False)
        h = _norm(p_l["ln_x"], x, cfg)
        x = x + cross_attention(p_l["cross"], h, state["xk"][l], state["xv"][l],
                                state["enc_pos"], positions, cfg=cfg, pctx=pctx)
        h = _norm(p_l["ln2"], x, cfg)
        x = x + mlp(p_l["mlp"], h, mlp_type=cfg.mlp_type, compute_dtype=dt)
    x = _norm(params["dec_norm"], x, cfg)
    logits = dense({"w": params["embed"]["table"].T}, x, dt)[:, 0]
    state["len"].add_(1)
    return logits, state


def encdec_serve_comm_bytes(layout, cfg, batch: int) -> dict[str, dict[str, float]]:
    """One :func:`encdec_decode_step`'s bytes a rank and direction, by link
    class, on parameters in the serve layout ``layout``, ``batch`` the rows
    one rank's step carries (``models.transformer.serve_comm_bytes``'s
    conventions, ``layers.TPBytes``'s closed forms).  ``"tp"``: the token's
    and the learned position's rows, each decoder layer's three norms, its
    self attention's four projections, its cross attention's ``wq`` and
    ``wo`` (the cross K/V are resident) and its MLP; the final norm and the
    tied head.  ``"link"``: the SP decode merge of each self and each cross
    read.  ``"data"``: nothing."""
    tb = TPBytes(layout.mesh, batch, torch_dtype(cfg.dtype).itemsize)
    specs, meta = layout.specs, layout.meta
    tp = (tb.embed(specs["embed"]["table"], meta["embed"]["table"])
          + tb.embed(specs["dec_pos"], meta["dec_pos"]))
    link = 0.0
    for s, m in zip(specs["dec_layers"], meta["dec_layers"]):
        tp += sum(tb.norm(s[k], m[k]) for k in ("ln1", "ln_x", "ln2"))
        tp += tb.attention(s["self"], m["self"], cfg)
        tp += tb.attention(s["cross"], m["cross"], cfg, keys=("wq", "wo"))
        tp += tb.ffn(s["mlp"], m["mlp"], cfg.d_model, cfg.d_ff)
        link += 2 * decode_link_bytes(cfg, batch, layout.mesh)
    tp += tb.norm(specs["dec_norm"], meta["dec_norm"]) + tb.head(layout, cfg)
    return comm_classes(tp, link)

"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks and local attention
(port of ``repro.models.rglru``; recurrentgemma-2b).

Block pattern (recurrentgemma-2b): ``(rec, rec, attn)`` repeating over 26
layers, 8 full periods ("superblocks", each temporal block followed by an
MLP block) and a 2-layer ``(rec, mlp)`` tail.  The JAX tree stacks the
superblocks and the tail for its scan over layers; here ``supers`` and
``tail`` are lists of per-block dicts (``models.convert`` unstacks them).

* The RG-LRU recurrence ``h_t = a_t h_{t-1} + b_t`` runs on the
  sequence-parallel scan (``core.api.sp_scan``), the sequence sharded
  contiguously over the context's ring; its gates, ``log a`` and ``b`` are
  float32, as in the reference.
* The recurrent block's K-4 causal conv runs over the global sequence: on
  a process group each rank takes the previous rank's last ``K - 1`` rows
  by one ring shift (``models.mamba._conv_halo``); on the virtual ring the
  tensors are global and need none.
* Local attention (window 2048, MQA, head dim 256) goes through
  ``attention(..., window=cfg.window)``: kernel A's D-256 instances and
  B1/B2 on the card; with ``sp_degree > 1`` the plan resolves the windowed
  layer to the halo-exchange strategy (``core/window.py``), which needs the
  context's ``layout="contig"``.
* ``cfg.remat`` ``"full"`` (and ``"dots"``, which the reference treats
  alike) recomputes each superblock and each tail pair in the backward, as
  ``jax.checkpoint`` over each scan body does.

Decode keeps O(window) attention state and O(1) recurrent state: per rec
block the float32 ``h`` and the ``(K-1)``-row conv window; per attention
layer a K/V ring buffer of exactly ``window`` slots written at slot ``len
% window``, with one ``pos (B, window)`` table (``PAD_POS`` where unwritten)
shared by the layers.  :func:`rg_decode_step` updates the state in place
and returns it (the port's serving convention).  The state is recurrent, so
it cannot be rolled back per slot: the serving engine refuses the bundle,
as the JAX engine does.

With ``sp_degree > 1`` the ring buffer is sequence-sharded over the ring
like the transformer's dense slab (``serving.kv_cache``): contiguous, slot
``s`` on rank ``s // (window / P)``, so the write at ``len % window`` lands
on the rank that holds that slot, and the attention merges the ranks'
partials (``core/decode.py``); on the pod mesh over ``("pod", "model")``
in the reference's pod-major order, as the dense slab.  On a mesh whose
sequence axes have ``n > 1`` ranks the recurrent state is split by ``lru``
over them (``sharding.serve_state_shardings``; ``n = pods * G`` on the
pod mesh, the slices model-major, ``layers.state_tp``): ``(..., n*B, ...,
lru/n)`` slice-major on the virtual mesh, this rank's ``(..., B, ...,
lru/n)`` on a process group.  The step takes whole parameters or serve storage (the
reference's Megatron layout), and a recurrent block runs its channels on
the ranks' slices (``models.layers``): ``lin_x``, ``lin_y``, the conv and
``lam`` by ``lru``; the conv's output gathered whole once for the gates
(over ``("pod", "model")`` on the pod mesh), whose weights the rule
splits by their output columns, so that each rank's gates match its slice
of ``h`` (its part of its model block's columns on the pod mesh);
``lin_out`` split by rows, one sum over the state's ranks.
The attention's q, k and v come out gathered whole (the rule splits
``wq`` inside a head: nothing assumes the heads divide the model size);
the tied head is a row-split product over the vocabulary.
:func:`rg_serve_comm_bytes` is the closed form of the step's bytes on
serve storage.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.api import sp_scan
from repro_torch.kernels.ref import PAD_POS
from repro_torch.models.attention import attention, attention_decode, attention_init
from repro_torch.models.layers import (
    ONE_RANK,
    TPBytes,
    apply_norm,
    comm_classes,
    dense,
    dense_init,
    dense_split_in,
    dense_split_out,
    embed_init,
    embed_lookup,
    held_ranks,
    lm_cross_entropy,
    mlp,
    mlp_init,
    norm_init,
    state_tp,
    torch_dtype,
    tp_slices,
)
from repro_torch.models.mamba import _causal_conv, _conv_halo
from repro_torch.models.transformer import _dense_plan, decode_link_bytes
from repro_torch.serving.kv_cache import apply_drop, sp_ranks
from repro_torch.sharding import bind_serve, layer_params

__all__ = [
    "init_rg",
    "rg_apply",
    "rg_loss",
    "rg_decode_step",
    "init_rg_state",
    "rg_layout",
    "rg_serve_comm_bytes",
]

_C_RGLRU = 8.0


def rg_layout(cfg) -> tuple[int, int]:
    """``(superblocks, tail layers)`` of ``cfg.n_layers`` over the block
    pattern's period."""
    return divmod(cfg.n_layers, len(cfg.block_pattern) or 3)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _rec_block_init(gen, cfg, device, training):
    d, lru, K = cfg.d_model, cfg.lru_width or cfg.d_model, cfg.ssm_conv
    wdt = cfg.param_dtype if training else cfg.dtype
    pdt = torch_dtype(cfg.param_dtype)
    conv_w = torch.randn((K, lru), generator=gen, device=device, dtype=torch.float32)
    lam = torch.rand((lru,), generator=gen, device=device, dtype=torch.float32)
    return {
        "norm": norm_init(d, norm_type=cfg.norm_type, dtype=cfg.param_dtype, device=device),
        "lin_y": dense_init(gen, d, lru, dtype=wdt, device=device),
        "lin_x": dense_init(gen, d, lru, dtype=wdt, device=device),
        "conv_w": (conv_w / math.sqrt(K)).to(pdt),
        "conv_b": torch.zeros((lru,), dtype=pdt, device=device),
        # the gates compute in float32: stored in param_dtype in both layouts
        "gate_a": dense_init(gen, lru, lru, dtype=cfg.param_dtype, device=device),
        "gate_i": dense_init(gen, lru, lru, dtype=cfg.param_dtype, device=device),
        # Λ so that a^c lands in [0.9, 0.999] at r = 1 (griffin appendix)
        "lam": (2.0 + 4.0 * lam).to(pdt),
        "lin_out": dense_init(gen, lru, d, dtype=wdt, device=device),
    }


def _mlp_block_init(gen, cfg, device, training):
    wdt = cfg.param_dtype if training else cfg.dtype
    return {
        "norm": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype,
                          device=device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, mlp_type=cfg.mlp_type, dtype=wdt,
                        device=device),
    }


def _attn_block_init(gen, cfg, device, training):
    return {
        "norm": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype,
                          device=device),
        "attn": attention_init(gen, cfg, device=device, training=training),
    }


def _super_init(gen, cfg, device, training):
    """One ``(rec, rec, attn)`` period, each temporal block followed by an
    MLP block."""
    return {
        "rec1": _rec_block_init(gen, cfg, device, training),
        "mlp1": _mlp_block_init(gen, cfg, device, training),
        "rec2": _rec_block_init(gen, cfg, device, training),
        "mlp2": _mlp_block_init(gen, cfg, device, training),
        "attn": _attn_block_init(gen, cfg, device, training),
        "mlp3": _mlp_block_init(gen, cfg, device, training),
    }


def init_rg(cfg, gen: torch.Generator, device="cuda", training: bool = False):
    """Random parameters from ``gen`` (a generator on ``device``), with the
    JAX init's distributions: ``embed``, ``supers`` and ``tail`` (lists of
    per-block dicts), ``final_norm`` (the head is tied unless the config
    says otherwise).  ``training`` stores every leaf in
    ``cfg.param_dtype``; by default (serving) the dense weights and the
    embedding table are in ``cfg.dtype``, and the gates, ``lam``, the conv
    and the norms in ``cfg.param_dtype``."""
    n_super, n_tail = rg_layout(cfg)
    wdt = cfg.param_dtype if training else cfg.dtype
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=wdt, device=device),
        "supers": [_super_init(gen, cfg, device, training) for _ in range(n_super)],
        "final_norm": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype,
                                device=device),
    }
    if n_tail:
        params["tail"] = [{"rec": _rec_block_init(gen, cfg, device, training),
                           "mlp": _mlp_block_init(gen, cfg, device, training)}
                          for _ in range(n_tail)]
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=wdt,
                                       device=device)
    return params


# ---------------------------------------------------------------------------
# forward blocks
# ---------------------------------------------------------------------------


def _decay(lam, r):
    """``(a, sqrt(1 - a^2))``, float32, from ``lam`` and the recurrence gate
    ``r``."""
    a = torch.exp(-_C_RGLRU * F.softplus(lam.float()) * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9))


def _gates(p, xb):
    """``(a, sqrt(1 - a^2))`` and the input gate ``i``, float32, from the
    conv'd branch ``xb``."""
    r = torch.sigmoid(dense(p["gate_a"], xb, torch.float32))
    i = torch.sigmoid(dense(p["gate_i"], xb, torch.float32))
    return (*_decay(p["lam"], r), i)


def _rglru(p, xb, *, pctx):
    """RG-LRU recurrence on the conv'd branch ``xb (B,S,lru)`` -> ``(B,S,lru)``
    in ``xb``'s dtype; the scan in float32."""
    a, norm_b, i = _gates(p, xb)
    b = norm_b * (i * xb.float())
    h = sp_scan(a, b, pctx=pctx, axis=1)
    return h.to(xb.dtype)


def _rec_block(p, x, *, cfg, pctx):
    dt = torch_dtype(cfg.dtype)
    h = apply_norm(p["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    yb = F.gelu(dense(p["lin_y"], h, dt), approximate="tanh")
    xb = dense(p["lin_x"], h, dt)
    halo = _conv_halo(xb, cfg.ssm_conv, pctx)
    xb = _causal_conv(xb, p["conv_w"].to(dt), p["conv_b"].to(dt), halo)
    hrec = _rglru(p, xb, pctx=pctx)
    return x + dense(p["lin_out"], hrec * yb, dt)


def _mlp_block(p, x, *, cfg):
    h = apply_norm(p["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    return x + mlp(p["mlp"], h, mlp_type=cfg.mlp_type, compute_dtype=torch_dtype(cfg.dtype))


def _attn_block(p, x, positions, *, cfg, pctx):
    h = apply_norm(p["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    return x + attention(p["attn"], h, positions, cfg=cfg, pctx=pctx, window=cfg.window)


def _super_block(p, x, positions, *, cfg, pctx):
    x = _rec_block(p["rec1"], x, cfg=cfg, pctx=pctx)
    x = _mlp_block(p["mlp1"], x, cfg=cfg)
    x = _rec_block(p["rec2"], x, cfg=cfg, pctx=pctx)
    x = _mlp_block(p["mlp2"], x, cfg=cfg)
    x = _attn_block(p["attn"], x, positions, cfg=cfg, pctx=pctx)
    return _mlp_block(p["mlp3"], x, cfg=cfg)


def _tail_block(p, x, *, cfg, pctx):
    x = _rec_block(p["rec"], x, cfg=cfg, pctx=pctx)
    return _mlp_block(p["mlp"], x, cfg=cfg)


def rg_apply(params, tokens, positions, *, cfg, pctx):
    """Hidden states ``(B,S,d)`` after the final norm: global tensors on
    the virtual ring, this rank's contiguous shard on a process group.  A
    superblock or tail layer of FSDP blocks (``sharding.LayerBlocks``) is
    gathered first, inside the remat region."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    x = params["embed"]["table"][tokens.long()].to(torch_dtype(cfg.dtype))
    remat = cfg.remat != "none" and torch.is_grad_enabled()

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    def sup(p_s, x):
        return _super_block(layer_params(p_s), x, positions, cfg=cfg, pctx=pctx)

    def tail(p_t, x):
        return _tail_block(layer_params(p_t), x, cfg=cfg, pctx=pctx)

    for p_s in params["supers"]:
        x = run(sup, p_s, x)
    for p_t in params.get("tail", ()):
        x = run(tail, p_t, x)
    return apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)


def _head_w(params, cfg):
    return params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]


def rg_loss(params, batch, *, cfg, pctx):
    """Causal LM loss of ``batch`` (tokens/positions/labels, +mask):
    ``(loss, metrics)``."""
    dt = torch_dtype(cfg.dtype)
    x = rg_apply(params, batch["tokens"], batch["positions"], cfg=cfg, pctx=pctx)
    loss, denom = lm_cross_entropy(x, _head_w(params, cfg).to(dt), batch["labels"],
                                   mask=batch.get("mask"), chunk=cfg.logits_chunk,
                                   compute_dtype=dt)
    return loss, {"ce_loss": loss, "tokens": denom}


# ---------------------------------------------------------------------------
# decode (O(window) attention cache + O(1) recurrent state)
# ---------------------------------------------------------------------------


def init_rg_state(cfg, batch: int, device="cuda", pctx=None):
    """The decode state of ``batch`` rows, zero recurrent state and an empty
    ring buffer (every slot at ``PAD_POS``), laid out for ``pctx`` (module
    docstring): the ring buffer sequence-sharded over its ring, the
    recurrent state split by ``lru`` over its mesh's sequence axes."""
    n_super, n_tail = rg_layout(cfg)
    lru, K, W = cfg.lru_width or cfg.d_model, cfg.ssm_conv, cfg.window
    dt = torch_dtype(cfg.dtype)
    P, rank = sp_ranks(pctx)
    tp = state_tp(pctx)
    G = tp.tp_size
    if W % P or lru % G:
        raise ValueError(f"window={W} and lru_width={lru} must split over the SP degree {P} "
                         f"and the state's {G} ranks")
    kv_rows, rec_rows, wl = (batch * P if rank is None else batch), held_ranks(tp) * batch, lru // G
    kv = (n_super, kv_rows, W // P, cfg.n_kv_heads, cfg.head_dim)
    state = {
        "rec_h": torch.zeros((n_super, 2, rec_rows, wl), dtype=torch.float32, device=device),
        "rec_conv": torch.zeros((n_super, 2, rec_rows, K - 1, wl), dtype=dt, device=device),
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "pos": torch.full((kv_rows, W // P), PAD_POS, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if n_tail:
        state["tail_h"] = torch.zeros((n_tail, rec_rows, wl), dtype=torch.float32,
                                      device=device)
        state["tail_conv"] = torch.zeros((n_tail, rec_rows, K - 1, wl), dtype=dt, device=device)
    return state


def _rec_block_decode(p, x, h_state, conv_state, *, cfg, tp=ONE_RANK):
    """One-token step of a recurrent block: ``x (B,1,d)``; the states are
    the ranks' slices by ``lru``, ``h_state (k,B,lru/n)`` float32 and
    ``conv_state (k,B,K-1,lru/n)`` (``k = n = 1`` unsplit), on ``tp``'s
    collectives (module docstring).  Returns ``(y, h', conv')``."""
    dt = torch_dtype(cfg.dtype)
    h = apply_norm(p["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    yb = F.gelu(dense_split_out(p["lin_y"], h, dt, tp), approximate="tanh")  # (k,B,1,lru/G)
    xb = dense_split_out(p["lin_x"], h, dt, tp)
    window = torch.cat([conv_state, xb], dim=2)  # (k,B,K,lru/G): the state, then the new token
    w = tp_slices(p["conv_w"], 1, tp).to(dt)
    # the window's products summed in order, as _causal_conv sums them (the
    # reference's einsum over k): the same rounding as the forward pass's
    xb = (sum(window[:, :, j] * w[:, None, j] for j in range(w.shape[1]))
          + tp_slices(p["conv_b"], 0, tp).to(dt)[:, None])  # (k,B,lru/G)
    whole_xb = tp.tp_gather(xb, -1)[:, None]  # (B,1,lru): the gates split by output columns
    r = torch.sigmoid(dense_split_out(p["gate_a"], whole_xb, torch.float32, tp))[:, :, 0]
    i = torch.sigmoid(dense_split_out(p["gate_i"], whole_xb, torch.float32, tp))[:, :, 0]
    a, norm_b = _decay(tp_slices(p["lam"], 0, tp)[:, None], r)
    h_new = a * h_state + norm_b * (i * xb.float())
    y = (h_new.to(dt) * yb[:, :, 0])[:, :, None]
    return x + dense_split_in(p["lin_out"], y, dt, tp), h_new, window[:, :, 1:]


@torch.inference_mode()
def rg_decode_step(params, token_ids, state, *, cfg, pctx):
    """``token_ids (B,)`` -> ``(logits (B,V), state)``: one token a row at
    position ``len``, its K/V written at ring-buffer slot ``len % window``
    (the drop plan every attention layer reuses, on the rank that holds
    the slot with ``sp_degree > 1``); the state is updated in place.
    ``params`` may be in serve storage (module docstring)."""
    if pctx.storage is not None:
        bind_serve(params, pctx.storage)
    tp = state_tp(pctx)
    k = held_ranks(tp)
    W = cfg.window
    dt = torch_dtype(cfg.dtype)
    length = state["len"]
    positions = length[:, None].clone()
    plan = _dense_plan(state, torch.arange(length.shape[0], device=length.device), length % W,
                       pctx)
    apply_drop(state["pos"], plan, positions[:, 0])  # includes the new token

    def rec(p, x, h_state, conv_state):
        x, h, c = _rec_block_decode(p, x, h_state.unflatten(0, (k, -1)),
                                    conv_state.unflatten(0, (k, -1)), cfg=cfg, tp=tp)
        h_state.copy_(h.flatten(0, 1))
        conv_state.copy_(c.flatten(0, 1))
        return x

    x = embed_lookup(params["embed"]["table"], token_ids.long()[:, None]).to(dt)
    for s, p_s in enumerate(params["supers"]):
        for j, name in enumerate(("rec1", "rec2")):
            x = rec(p_s[name], x, state["rec_h"][s, j], state["rec_conv"][s, j])
            x = _mlp_block(p_s[f"mlp{j + 1}"], x, cfg=cfg)
        h = apply_norm(p_s["attn"]["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
        x = x + attention_decode(p_s["attn"]["attn"], h, positions, state["k"][s],
                                 state["v"][s], state["pos"], plan, cfg=cfg, pctx=pctx,
                                 window=W)
        x = _mlp_block(p_s["mlp3"], x, cfg=cfg)
    for t, p_t in enumerate(params.get("tail", ())):
        x = rec(p_t["rec"], x, state["tail_h"][t], state["tail_conv"][t])
        x = _mlp_block(p_t["mlp"], x, cfg=cfg)
    x = apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    logits = dense({"w": _head_w(params, cfg)}, x, dt)[:, 0]
    length += 1
    return logits, state


def rg_serve_comm_bytes(layout, cfg, batch: int) -> dict[str, dict[str, float]]:
    """One :func:`rg_decode_step`'s bytes a rank and direction, by link
    class, on parameters in the serve layout ``layout``, ``batch`` the rows
    one rank's step carries (``models.transformer.serve_comm_bytes``'s
    conventions, ``layers.TPBytes``'s closed forms).  ``"tp"``: the
    embedding's rows; a recurrent block's norm scale, ``lin_x``'s and
    ``lin_y``'s outputs where they are not split by their columns, each of
    ``conv_w``, ``conv_b`` and ``lam`` that the rule splits off ``lru``
    gathered whole, the conv's output gathered over the state's ranks for
    the gates and their outputs where not split by columns, ``lin_out``'s
    partials summed over the state's ranks; an
    MLP block's and an attention block's as the transformer's; the final
    norm and the tied head.  ``"link"``: each attention layer's SP decode
    merge.  ``"data"``: nothing."""
    lru = cfg.lru_width or cfg.d_model
    e = torch_dtype(cfg.dtype).itemsize
    tb = TPBytes(layout.mesh, batch, e)

    def rec(specs, meta):
        return (tb.norm(specs["norm"], meta["norm"])
                + sum(tb.split_out(specs[key], meta[key], lru * e) for key in ("lin_x", "lin_y"))
                + sum(tb.slices(specs[key], meta[key], dim)
                      for key, dim in (("conv_w", 1), ("conv_b", 0), ("lam", 0)))
                + tb.state_gathered(batch * lru * e)
                + sum(tb.split_out(specs[key], meta[key], lru * 4) for key in ("gate_a", "gate_i"))
                + tb.split_in(specs["lin_out"], meta["lin_out"], lru * e, cfg.d_model * e))

    def mlp_block(specs, meta):
        return tb.norm(specs["norm"], meta["norm"]) + tb.ffn(specs["mlp"], meta["mlp"],
                                                             cfg.d_model, cfg.d_ff)

    tp = tb.embed(layout.specs["embed"]["table"], layout.meta["embed"]["table"])
    link = 0.0
    for specs, meta in zip(layout.specs["supers"], layout.meta["supers"]):
        tp += rec(specs["rec1"], meta["rec1"]) + rec(specs["rec2"], meta["rec2"])
        tp += sum(mlp_block(specs[f"mlp{j}"], meta[f"mlp{j}"]) for j in (1, 2, 3))
        a, am = specs["attn"], meta["attn"]
        tp += tb.norm(a["norm"], am["norm"]) + tb.attention(a["attn"], am["attn"], cfg)
        link += decode_link_bytes(cfg, batch, layout.mesh)
    for specs, meta in zip(layout.specs.get("tail", ()), layout.meta.get("tail", ())):
        tp += rec(specs["rec"], meta["rec"]) + mlp_block(specs["mlp"], meta["mlp"])
    tp += tb.norm(layout.specs["final_norm"], layout.meta["final_norm"]) + tb.head(layout, cfg)
    return comm_classes(tp, link)

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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.api import sp_scan
from repro_torch.kernels.ref import PAD_POS
from repro_torch.models.attention import (
    attention,
    attention_decode,
    attention_init,
    ring_write_plan,
)
from repro_torch.models.layers import (
    apply_norm,
    dense,
    dense_init,
    embed_init,
    lm_cross_entropy,
    mlp,
    mlp_init,
    norm_init,
    torch_dtype,
)
from repro_torch.models.mamba import _causal_conv, _conv_halo
from repro_torch.serving.kv_cache import apply_drop
from repro_torch.sharding import layer_params

__all__ = [
    "init_rg",
    "rg_apply",
    "rg_loss",
    "rg_decode_step",
    "init_rg_state",
    "rg_layout",
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


def _gates(p, xb):
    """``(a, sqrt(1 - a^2))`` and the input gate ``i``, float32, from the
    conv'd branch ``xb``."""
    r = torch.sigmoid(dense(p["gate_a"], xb, torch.float32))
    i = torch.sigmoid(dense(p["gate_i"], xb, torch.float32))
    a = torch.exp(-_C_RGLRU * F.softplus(p["lam"].float()) * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)), i


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


def init_rg_state(cfg, batch: int, device="cuda"):
    """The decode state of ``batch`` rows, zero recurrent state and an empty
    ring buffer (every slot at ``PAD_POS``)."""
    n_super, n_tail = rg_layout(cfg)
    lru, K, W = cfg.lru_width or cfg.d_model, cfg.ssm_conv, cfg.window
    dt = torch_dtype(cfg.dtype)
    kv = (n_super, batch, W, cfg.n_kv_heads, cfg.head_dim)
    state = {
        "rec_h": torch.zeros((n_super, 2, batch, lru), dtype=torch.float32, device=device),
        "rec_conv": torch.zeros((n_super, 2, batch, K - 1, lru), dtype=dt, device=device),
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        "pos": torch.full((batch, W), PAD_POS, dtype=torch.int32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if n_tail:
        state["tail_h"] = torch.zeros((n_tail, batch, lru), dtype=torch.float32, device=device)
        state["tail_conv"] = torch.zeros((n_tail, batch, K - 1, lru), dtype=dt, device=device)
    return state


def _rec_block_decode(p, x, h_state, conv_state, *, cfg):
    """One-token step of a recurrent block: ``x (B,1,d)``, ``h_state
    (B,lru)`` float32, ``conv_state (B,K-1,lru)``; returns ``(y, h', conv')``."""
    dt = torch_dtype(cfg.dtype)
    h = apply_norm(p["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    yb = F.gelu(dense(p["lin_y"], h, dt), approximate="tanh")  # (B,1,lru)
    xb = dense(p["lin_x"], h, dt)
    window = torch.cat([conv_state, xb], dim=1)  # (B,K,lru): the state, then the new token
    w = p["conv_w"].to(dt)
    # the window's products summed in order, as _causal_conv sums them (the
    # reference's einsum over k): the same rounding as the forward pass's
    xb = (sum(window[:, k] * w[k] for k in range(w.shape[0])) + p["conv_b"].to(dt))[:, None]
    a, norm_b, i = _gates(p, xb)
    h_new = a[:, 0] * h_state + norm_b[:, 0] * (i[:, 0] * xb[:, 0].float())
    y = (h_new.to(dt) * yb[:, 0])[:, None]
    return x + dense(p["lin_out"], y, dt), h_new, window[:, 1:]


@torch.inference_mode()
def rg_decode_step(params, token_ids, state, *, cfg, pctx):
    """``token_ids (B,)`` -> ``(logits (B,V), state)``: one token a row at
    position ``len``, its K/V written at ring-buffer slot ``len % window``
    (the drop plan every attention layer reuses); the state is updated in
    place.  Sequence-parallel decode of the hybrid is not built (the JAX
    package serves it on one device): ``sp_degree > 1`` raises."""
    if pctx.active:
        raise ValueError("rg_decode_step runs at sp_degree 1: the hybrid's ring-buffer state "
                         "is not sequence-sharded")
    W = cfg.window
    dt = torch_dtype(cfg.dtype)
    length = state["len"]
    positions = length[:, None].clone()
    plan = ring_write_plan(length, W)
    apply_drop(state["pos"], plan, positions[:, 0])  # includes the new token
    x = params["embed"]["table"][token_ids.long()[:, None]].to(dt)
    for s, p_s in enumerate(params["supers"]):
        for j, name in enumerate(("rec1", "rec2")):
            x, h, c = _rec_block_decode(p_s[name], x, state["rec_h"][s, j],
                                        state["rec_conv"][s, j], cfg=cfg)
            state["rec_h"][s, j].copy_(h)
            state["rec_conv"][s, j].copy_(c)
            x = _mlp_block(p_s[f"mlp{j + 1}"], x, cfg=cfg)
        h = apply_norm(p_s["attn"]["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
        x = x + attention_decode(p_s["attn"]["attn"], h, positions, state["k"][s],
                                 state["v"][s], state["pos"], plan, cfg=cfg, pctx=pctx,
                                 window=W)
        x = _mlp_block(p_s["mlp3"], x, cfg=cfg)
    for t, p_t in enumerate(params.get("tail", ())):
        x, h, c = _rec_block_decode(p_t["rec"], x, state["tail_h"][t], state["tail_conv"][t],
                                    cfg=cfg)
        state["tail_h"][t].copy_(h)
        state["tail_conv"][t].copy_(c)
        x = _mlp_block(p_t["mlp"], x, cfg=cfg)
    x = apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    logits = (x.to(dt) @ _head_w(params, cfg).to(dt))[:, 0]
    length += 1
    return logits, state

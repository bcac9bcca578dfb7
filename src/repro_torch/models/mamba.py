"""Mamba-1 (selective SSM) blocks: falcon-mamba-7b (port of
``repro.models.mamba``).

TokenRing does not apply (no attention); the sequence-parallel substrate is
the distributed prefix scan (``core/recurrence.py``).  The selective scan is
the memory hot spot: the (B, S, d_inner, d_state) transition tensor is ~16x
the activation size (4.3 GB a layer at full width, batch 2 x 4096), so it
is never built.  The scan runs in two chunked passes:

  pass 1 (summary, :func:`_summary_pass`): chunk by chunk, carrying only the
      state ``h (B, d_inner, N)``; the shard's decay product needs no scan
      (``prod_t exp(dt_t A) = exp(A * sum_t dt_t)``);
  across ranks: ``device_exclusive_scan`` (``ceil(log2 P)`` doubling
      shifts and one exclusive shift);
  pass 2 (emit, :func:`_selective_scan_local`): chunk by chunk again from
      the incoming state, emitting ``y = C.h + D x``.

One chunk's ``(B, chunk, d_inner, N)`` (``cfg.scan_chunk``) is the largest
transient, and each chunk of both passes runs under
``torch.utils.checkpoint`` (``jax.checkpoint`` in the reference), so the
backward recomputes it rather than keeping it.  Within a chunk the scan is
``core.recurrence.inclusive_scan``'s doubling.  ``cfg.remat`` ``"full"``
(and ``"dots"``, which the reference treats alike) recomputes each layer in
the backward, as the transformer's does.

Traps kept from the reference: ``mamba_layer`` passes ``A_log`` under the
name ``A`` and the scans negate ``exp(A)`` inside; the chunk halves until
it divides the sequence; ``dt`` is expanded from rank R inside the scan, so
only rank-R activations reach it; B, C and the state are float32; ``y *
silu(z)`` runs in the compute dtype.  ``dt_proj`` computes in float32, so
the serving layout keeps it in ``cfg.param_dtype`` (``models.layers``).

With ``sp_degree > 1`` the scan runs over the context's ring with the
sequence sharded contiguously: on the virtual ring every function here
takes global tensors and only the scan folds the ranks into the batch; on
a process group each rank holds its contiguous shard, and the causal conv
takes its ``K - 1`` rows of halo from the previous rank by a ring shift.

Decode is O(1) a token: the state ``ssm (L, B, d_inner, N)`` float32 and
the conv window ``conv (L, B, K-1, d_inner)``.  :func:`mamba_decode_step`
updates the state in place and returns it (the port's serving convention).

On a mesh whose sequence axes have ``n > 1`` ranks the state is split by
``d_inner`` over them, as ``sharding.serve_state_shardings`` gives it
(``model``: ``n = G``; ``("pod", "model")`` on the pod mesh: ``n = pods *
G``, the slices model-major, ``layers.state_tp``): ``(L, n*B, d_inner/n,
...)`` slice-major on the virtual mesh, this rank's ``(L, B, d_inner/n,
...)`` on a process group.  The step takes whole
parameters or serve storage (``sharding.shard_tree`` of a ``mode="serve"``
layout, the reference's Megatron layout), and each layer runs its
channels on the ranks' slices (``models.layers``): the conv, ``dt``, the
recurrence, ``D`` and the gate by ``d_inner``; ``in_proj``'s output
gathered whole, since the rule splits its concatenated ``[x | z]``
columns, which line up with no rank's slice; ``x_c`` gathered for
``x_proj``, whose output (``dt_in``, B, C) is whole; ``A_log``, which the
rule splits by ``N``, gathered whole; ``out_proj`` split by rows, one
sum.  On the pod mesh a rank's slice is a part of its model rank's share:
it takes its part of ``in_proj``'s two halves, of the column-split
``dt_proj`` and of ``conv_w``, ``conv_b`` and ``D``, gathers ``x_c`` over
``("pod", "model")`` and sums ``out_proj``'s partials over both.
:func:`mamba_serve_comm_bytes` is the closed form of the step's bytes on
serve storage.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import fold_ranks, unfold_ranks
from repro_torch.core.recurrence import device_exclusive_scan, inclusive_scan
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
    norm_init,
    state_tp,
    torch_dtype,
    tp_slices,
)
from repro_torch.sharding import bind_serve, layer_params

__all__ = [
    "mamba_layer_init",
    "mamba_layer",
    "mamba_layer_decode",
    "selective_scan_sp",
    "init_mamba_state",
    "init_mamba_lm",
    "mamba_apply",
    "mamba_loss",
    "mamba_decode_step",
    "mamba_serve_comm_bytes",
]


def mamba_layer_init(gen, cfg, device="cuda", training: bool = False):
    """One layer's parameters from ``gen``, with the JAX init's
    distributions (S4D-real ``A``, zero dt bias); dense weights in the
    serving or training layout, ``dt_proj`` and the rest in
    ``cfg.param_dtype``."""
    d, di, N, R, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_resolved, cfg.ssm_conv
    wdt = cfg.param_dtype if training else cfg.dtype
    pdt = torch_dtype(cfg.param_dtype)
    A = torch.arange(1, N + 1, dtype=torch.float32, device=device).expand(di, N)
    conv_w = torch.randn((K, di), generator=gen, device=device, dtype=torch.float32)
    return {
        "norm": norm_init(d, norm_type=cfg.norm_type, dtype=cfg.param_dtype, device=device),
        "in_proj": dense_init(gen, d, 2 * di, dtype=wdt, device=device),
        "conv_w": (conv_w / math.sqrt(K)).to(pdt),
        "conv_b": torch.zeros((di,), dtype=pdt, device=device),
        "x_proj": dense_init(gen, di, R + 2 * N, dtype=wdt, device=device),
        "dt_proj": dense_init(gen, R, di, bias=True, dtype=cfg.param_dtype, device=device),
        "A_log": torch.log(A).to(pdt).contiguous(),
        "D": torch.ones((di,), dtype=pdt, device=device),
        "out_proj": dense_init(gen, di, d, dtype=wdt, device=device),
    }


def _causal_conv(x, w, b, halo=None):
    """Depthwise causal conv along seq: x (B,S,di), w (K,di); ``halo (B,
    K-1, di)`` are the rows before ``x`` (zeros by default)."""
    K, S = w.shape[0], x.shape[1]
    if halo is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([halo, x], dim=1)
    y = sum(xp[:, k:k + S, :] * w[k] for k in range(K))
    return y + b


def _conv_halo(xi, K: int, pctx):
    """On a process group, the previous rank's last ``K - 1`` rows of
    ``xi`` (zeros on rank 0) by one ring shift; ``None`` elsewhere.  Every
    rank keeps the received tensor in its graph (selected away on rank 0)
    so that the shift's transpose runs on every rank in the backward."""
    if pctx is None or not pctx.active or pctx.ring.folded or K == 1:
        return None
    if xi.shape[1] < K - 1:
        raise ValueError(f"a shard of {xi.shape[1]} rows is shorter than the conv's halo of "
                         f"{K - 1}")
    ring = pctx.ring
    (recv,) = ring.post((xi[:, -(K - 1):].contiguous(),), 1).wait()
    first = torch.tensor(ring.rank == 0, device=xi.device)
    return torch.where(first, torch.zeros_like(recv), recv)


def _ssm_inputs(p, h, cfg, pctx=None):
    """Shared projections: returns ``(x_c, z, dt_in, Bs, Cs)``.  ``dt_in``
    stays at rank R; the float32 ``dt (B,S,di)`` is expanded inside the
    scan."""
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_resolved
    dt_ = torch_dtype(cfg.dtype)
    xz = dense(p["in_proj"], h, dt_)
    xi, z = xz[..., :di], xz[..., di:]
    halo = _conv_halo(xi, cfg.ssm_conv, pctx)
    x_c = F.silu(_causal_conv(xi, p["conv_w"].to(dt_), p["conv_b"].to(dt_), halo))
    xdb = dense(p["x_proj"], x_c, dt_)
    dt_in, Bs, Cs = xdb[..., :R], xdb[..., R:R + N], xdb[..., R + N:]
    return x_c, z, dt_in, Bs.float(), Cs.float()


def _expand_dt(dt_in, dt_w, dt_b):
    """dt (B,S,di) float32 from the rank-R ``dt_in``."""
    return F.softplus(dt_in.float() @ dt_w.float() + dt_b.float())


def _chunk_scan(h0, a, b):
    """Inclusive scan of one chunk ``a``/``b (B,c,di,N)`` from the incoming
    state ``h0 (B,di,N)``: returns ``(h_seq, h_last)``."""
    A_cum, h = inclusive_scan(a, b, axis=1)
    h = h + A_cum * h0[:, None]
    return h, h[:, -1]


def _chunk_len(S: int, chunk: int) -> int:
    """``chunk`` halved until it divides ``S``."""
    chunk = max(1, min(chunk, S))
    while S % chunk:
        chunk //= 2
    return chunk


def _chunk_ab(xcb, dtb, Bb, A):
    """The chunk's transitions ``a = exp(dt A)`` and inputs ``b = dt x B``,
    ``(B,c,di,N)`` float32, with ``A`` the stored ``A_log``."""
    a = torch.exp(dtb[..., None] * (-torch.exp(A))[None, None])
    b = (dtb * xcb.float())[..., None] * Bb[:, :, None, :]
    return a, b


def _emit_chunk(h0, xcb, dtb, Bb, Cb, A, D):
    a, b = _chunk_ab(xcb, dtb, Bb, A)
    h, h_last = _chunk_scan(h0, a, b)
    y = torch.einsum("bcdn,bcn->bcd", h, Cb) + D[None, None] * xcb.float()
    return h_last, y


def _summ_chunk(h0, xcb, dtb, Bb, A):
    a, b = _chunk_ab(xcb, dtb, Bb, A)
    return _chunk_scan(h0, a, b)[1]


def _run_chunk(fn, *args):
    """One chunk of a pass, under ``torch.utils.checkpoint`` when a backward
    will follow (its ``(B, chunk, di, N)`` tensors are recomputed there)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _selective_scan_local(x_c, dt, Bs, Cs, A, D, h_in, chunk):
    """Two-pass chunked scan's emit pass on local data.  Shapes:
    x_c (B,S,di), dt (B,S,di), Bs/Cs (B,S,N), A (di,N), h_in (B,di,N).
    Returns y (B,S,di) float32, h_last (B,di,N)."""
    S = x_c.shape[1]
    chunk = _chunk_len(S, chunk)
    h, ys = h_in, []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h, y = _run_chunk(_emit_chunk, h, x_c[:, sl], dt[:, sl], Bs[:, sl], Cs[:, sl], A, D)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _summary_pass(x_c, dt, Bs, A, chunk):
    """Pass 1: the shard's final state under a zero initial state and its
    decay product (no scan for the product: ``prod_t exp(dt_t A) = exp(A *
    sum_t dt_t)``).  Returns ``(A_prod, h_last)``, each ``(B,di,N)``."""
    B, S, di = x_c.shape
    N = Bs.shape[-1]
    A_prod = torch.exp(torch.einsum("bsd,dn->bdn", dt, -torch.exp(A)))
    chunk = _chunk_len(S, chunk)
    h = torch.zeros((B, di, N), dtype=torch.float32, device=x_c.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        h = _run_chunk(_summ_chunk, h, x_c[:, sl], dt[:, sl], Bs[:, sl], A)
    return A_prod, h


def selective_scan_sp(x_c, dt_in, Bs, Cs, dt_w, dt_b, A, D, *, pctx, chunk):
    """Sequence-parallel selective scan, the sequence sharded contiguously
    over the context's ring: global tensors on the virtual ring (folded to
    the ranks' shards for the scan and back), this rank's shard on a
    process group.  ``dt_in (B,S,R)`` is expanded to ``dt (B,S,di)`` per
    shard.  Returns ``y (B,S,di)`` float32."""
    if not pctx.active:
        dt = _expand_dt(dt_in, dt_w, dt_b)
        B, _, di = x_c.shape
        h_in = torch.zeros((B, di, Bs.shape[-1]), dtype=torch.float32, device=x_c.device)
        y, _ = _selective_scan_local(x_c, dt, Bs, Cs, A, D, h_in, chunk)
        return y
    ring, P = pctx.ring, pctx.sp_degree
    if ring.folded:
        x_c, dt_in, Bs, Cs = (fold_ranks(t, P) for t in (x_c, dt_in, Bs, Cs))
    dt = _expand_dt(dt_in, dt_w, dt_b)
    A_prod, h_last = _summary_pass(x_c, dt, Bs, A, chunk)
    _, h_in = device_exclusive_scan((A_prod, h_last), ring)
    y, _ = _selective_scan_local(x_c, dt, Bs, Cs, A, D, h_in, chunk)
    return unfold_ranks(y, P) if ring.folded else y


def mamba_layer(p, x, *, cfg, pctx):
    """Full mamba block (pre-norm residual): x (B,S,d) -> (B,S,d)."""
    dt_ = torch_dtype(cfg.dtype)
    h = apply_norm(p["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    x_c, z, dt_in, Bs, Cs = _ssm_inputs(p, h, cfg, pctx)
    A = p["A_log"].float()
    D = p["D"].float()
    y = selective_scan_sp(x_c, dt_in, Bs, Cs, p["dt_proj"]["w"], p["dt_proj"]["b"], A, D,
                          pctx=pctx, chunk=cfg.scan_chunk)
    y = (y.to(dt_) * F.silu(z)).to(dt_)
    return x + dense(p["out_proj"], y, dt_)


# ---------------------------------------------------------------------------
# decode (O(1) state)
# ---------------------------------------------------------------------------


def init_mamba_state(cfg, batch: int, device="cuda", pctx=None):
    """The zero decode state of ``batch`` rows, split by ``d_inner`` over the
    sequence axes of ``pctx``'s mesh (module docstring)."""
    di, N, K, L = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv, cfg.n_layers
    tp = state_tp(pctx)
    G, rows = tp.tp_size, held_ranks(tp) * batch
    if di % G:
        raise ValueError(f"d_inner={di} does not split over the mesh's {G} sequence ranks")
    return {
        "ssm": torch.zeros((L, rows, di // G, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((L, rows, K - 1, di // G), dtype=torch_dtype(cfg.dtype),
                            device=device),
    }


def mamba_layer_decode(p, x, ssm_state, conv_state, *, cfg, tp=ONE_RANK):
    """One-token step: ``x (B,1,d)``; returns ``(y, ssm_state', conv_state')``.
    The states are the ranks' slices by ``d_inner``, ``ssm (k,B,di/n,N)``
    and ``conv (k,B,K-1,di/n)`` (``k = n = 1`` unsplit), on ``tp``'s
    collectives (module docstring)."""
    di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_resolved
    dt_ = torch_dtype(cfg.dtype)
    h = apply_norm(p["norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    xz = dense(p["in_proj"], h, dt_)  # (B,1,2di) whole
    xi, z = tp.tp_split(xz[..., :di], -1), tp.tp_split(xz[..., di:], -1)  # (k,B,1,di/G)
    window = torch.cat([conv_state, xi], dim=2)  # (k,B,K,di/G): the state, then the new token
    w = tp_slices(p["conv_w"], 1, tp).to(dt_)  # (k,K,di/G)
    # the window's products summed in order, as _causal_conv sums them (the
    # reference's einsum over k): the same rounding as the forward pass's
    conv = sum(window[:, :, j] * w[:, None, j] for j in range(w.shape[1]))
    x_c = F.silu(conv + tp_slices(p["conv_b"], 0, tp).to(dt_)[:, None])  # (k,B,di/G)
    new_conv = window[:, :, 1:]
    xdb = dense_split_in(p["x_proj"], x_c[:, :, None], dt_, tp)  # (B,1,R+2N) whole
    dt_in, Bs, Cs = xdb[..., :R], xdb[..., R:R + N], xdb[..., R + N:]
    dtv = F.softplus(dense_split_out(p["dt_proj"], dt_in, torch.float32, tp))[:, :, 0]
    A = -torch.exp(tp_slices(p["A_log"], 0, tp).float())  # (k,di/G,N)
    a = torch.exp(dtv[..., None] * A[:, None])  # (k,B,di/G,N)
    b = (dtv * x_c.float())[..., None] * Bs[None, :, 0, None, :].float()
    h_new = a * ssm_state + b
    y = torch.einsum("kbdn,bn->kbd", h_new, Cs[:, 0].float())
    y = y + tp_slices(p["D"], 0, tp).float()[:, None] * x_c.float()
    y = (y[:, :, None].to(dt_) * F.silu(z)).to(dt_)  # (k,B,1,di/G)
    out = x + dense_split_in(p["out_proj"], y, dt_, tp)
    return out, h_new, new_conv


# ---------------------------------------------------------------------------
# full LM wrappers (falcon-mamba)
# ---------------------------------------------------------------------------


def init_mamba_lm(cfg, gen: torch.Generator, device="cuda", training: bool = False):
    """Random parameters from ``gen`` (a generator on ``device``):
    ``embed``, ``layers`` (a list of per-layer dicts; the JAX tree stacks
    them), ``final_norm`` and the untied ``lm_head``.  ``training`` stores
    every leaf in ``cfg.param_dtype``; by default (serving) the dense
    weights but ``dt_proj`` and the embedding table are in ``cfg.dtype``."""
    wdt = cfg.param_dtype if training else cfg.dtype
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=wdt, device=device),
        "layers": [mamba_layer_init(gen, cfg, device, training) for _ in range(cfg.n_layers)],
        "final_norm": norm_init(cfg.d_model, norm_type=cfg.norm_type, dtype=cfg.param_dtype,
                                device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=wdt,
                                       device=device)
    return params


def _head_w(params, cfg):
    return params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]["w"]


def mamba_apply(params, tokens, *, cfg, pctx):
    """Hidden states ``(B,S,d)`` after the final norm.  A layer of FSDP
    blocks (``sharding.LayerBlocks``) is gathered first, inside the remat
    region."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    x = params["embed"]["table"][tokens.long()].to(torch_dtype(cfg.dtype))

    def body(p_l, x):
        return mamba_layer(layer_params(p_l), x, cfg=cfg, pctx=pctx)

    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for p_l in params["layers"]:
        x = checkpoint(body, p_l, x, use_reentrant=False) if remat else body(p_l, x)
    return apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)


def mamba_loss(params, batch, *, cfg, pctx):
    """Causal LM loss of ``batch`` (tokens/labels, +mask): ``(loss,
    metrics)``."""
    dt = torch_dtype(cfg.dtype)
    x = mamba_apply(params, batch["tokens"], cfg=cfg, pctx=pctx)
    loss, denom = lm_cross_entropy(x, _head_w(params, cfg).to(dt), batch["labels"],
                                   mask=batch.get("mask"), chunk=cfg.logits_chunk,
                                   compute_dtype=dt)
    return loss, {"ce_loss": loss, "tokens": denom}


@torch.inference_mode()
def mamba_decode_step(params, token_ids, state, *, cfg, pctx):
    """``token_ids (B,)`` -> ``(logits (B,V), state)``, O(1) a token; the
    state is updated in place.  ``params`` may be in serve storage (module
    docstring)."""
    if pctx.storage is not None:
        bind_serve(params, pctx.storage)
    tp = state_tp(pctx)
    k = held_ranks(tp)
    dt = torch_dtype(cfg.dtype)
    x = embed_lookup(params["embed"]["table"], token_ids.long()[:, None]).to(dt)
    for l, p_l in enumerate(params["layers"]):
        ssm, conv = state["ssm"][l], state["conv"][l]
        x, h, c = mamba_layer_decode(p_l, x, ssm.unflatten(0, (k, -1)),
                                     conv.unflatten(0, (k, -1)), cfg=cfg, tp=tp)
        ssm.copy_(h.flatten(0, 1))
        conv.copy_(c.flatten(0, 1))
    x = apply_norm(params["final_norm"], x, norm_type=cfg.norm_type, eps=cfg.norm_eps)
    logits = dense({"w": _head_w(params, cfg)}, x, dt)[:, 0]
    return logits, state


def mamba_serve_comm_bytes(layout, cfg, batch: int) -> dict[str, dict[str, float]]:
    """One :func:`mamba_decode_step`'s bytes a rank and direction, by link
    class, on parameters in the serve layout ``layout``, ``batch`` the rows
    one rank's step carries (``models.transformer.serve_comm_bytes``'s
    conventions, ``layers.TPBytes``'s closed forms).  ``"tp"``: the
    embedding's rows; a layer's norm scale, ``in_proj``'s output gathered
    whole, ``x_c`` gathered for ``x_proj`` over the state's ranks (summed
    partials if the rule splits it by rows) and ``x_proj``'s output, ``dt_proj``'s output where
    it is not split by its columns, each of ``conv_w``, ``conv_b``,
    ``A_log`` and ``D`` that the rule splits off ``d_inner`` gathered
    whole, ``out_proj``'s partials summed over the state's ranks; the final
    norm and the head.
    ``"link"`` and ``"data"``: nothing."""
    di, N, R, d = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_resolved, cfg.d_model
    e = torch_dtype(cfg.dtype).itemsize
    tb = TPBytes(layout.mesh, batch, e)
    tp = tb.embed(layout.specs["embed"]["table"], layout.meta["embed"]["table"])
    for specs, meta in zip(layout.specs["layers"], layout.meta["layers"]):
        tp += tb.norm(specs["norm"], meta["norm"])
        tp += tb.product(specs["in_proj"], meta["in_proj"], 2 * di * e)
        tp += sum(tb.slices(specs[key], meta[key], dim)
                  for key, dim in (("conv_w", 1), ("conv_b", 0), ("A_log", 0), ("D", 0)))
        tp += tb.split_in(specs["x_proj"], meta["x_proj"], di * e, (R + 2 * N) * e)
        tp += tb.split_out(specs["dt_proj"], meta["dt_proj"], di * 4)
        tp += tb.split_in(specs["out_proj"], meta["out_proj"], di * e, d * e)
    tp += tb.norm(layout.specs["final_norm"], layout.meta["final_norm"]) + tb.head(layout, cfg)
    return comm_classes(tp, 0.0)

"""Mixture-of-Experts FFN (port of ``repro.models.moe``): qwen3-moe's 128
experts top-8, llama4-scout's 16 experts top-1 with a shared expert.

GShard/Switch-style capacity dispatch, as in the JAX package:

  * routing in float32: the softmax of the router logits feeds the aux
    loss, the experts are the ``top_k`` of the logits and their gates the
    softmax over the K picked (qwen's ``norm_topk_prob``);
  * routing groups are **per batch row**: the position-in-expert cumsum
    runs over each row's ``S*K`` entries in order, and an entry whose
    position reaches the capacity ``C = ceil(S*K/E * capacity_factor)``
    (rounded up to 8) is dropped and contributes zero;
  * the dispatch buffer is ``(B, E, C, d)``; the experts are swiglu
    products batched over E (``torch.einsum``: a ``bmm``); the combine
    gathers each entry's expert output back, weighted by its gate;
  * the Switch load-balancing aux loss is returned for the trainer.

With ``sp_degree > 1`` the experts are sharded over the ring (expert
parallelism): :func:`_moe_ffn_a2a` when the tokens' global length divides
by the SP degree, :func:`_moe_ffn_replicated_seq` otherwise (decode, one
token a row).  Both are written once against the transport interface of
``core.collectives``: on the virtual ring every tensor carries a leading
rank dimension of ``P`` (the ranks folded, ``x`` global); on a process
group the rank dimension is 1 (``x`` this rank's shard in training, the
replicated chunk in serving).  Every scatter sends what it drops to an
overflow slot that is sliced off, so no live slot is written twice and the
accumulating ``index_put`` stays repeatable run to run on the card.

In serve storage (``repro_torch.sharding.ServeBlocks``) the expert stacks
are split by expert over ``model`` and replicated over ``pod`` and
``data``; the decode step's expert parallelism (the replicated-sequence
path) runs each rank's experts out of its own block and moves no expert
weight.  Where the experts shard over ``model`` alone (``E`` divides the
model size only: llama4's 16 on the production ring of 32), a rank's block
is its EP slice.  Where they shard over every SP rank of the pod mesh
(``E`` divides ``pods * G``: qwen3-moe's 128), a model block of ``E / G``
experts holds ``pods`` EP slices, and rank ``(pod p, model m)`` runs the
``p``-th of its own block: EP slice ``m * pods + p`` (:func:`_ep_slices`).
The output does not depend on which rank runs which expert (each expert's
entries keep their token order).  The router, split by columns, gives its
logits gathered whole before the top-k, and a shared expert runs as its
column/row pair (``models.layers``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import fold_ranks, unfold_ranks
from repro_torch.models.layers import dense, dense_init, mlp, mlp_init, torch_dtype
from repro_torch.sharding import ServeBlocks

__all__ = ["moe_init", "moe_ffn", "ep_size"]


def moe_init(gen, cfg, device="cuda", training: bool = False):
    """Router in ``cfg.param_dtype`` always (routing is float32, as the
    JAX code routes from its float32 parameter); the expert stacks ``wg``/
    ``wu`` ``(E, d, f)`` and ``wd`` ``(E, f, d)`` and the shared expert in
    ``cfg.param_dtype`` for training, ``cfg.dtype`` for serving."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    wdt = torch_dtype(cfg.param_dtype if training else cfg.dtype)

    def stack(shape, scale):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * scale
        return w.to(wdt)

    p = {
        "router": dense_init(gen, d, E, dtype=cfg.param_dtype, device=device),
        "wg": stack((E, d, f), 1.0 / math.sqrt(d)),
        "wu": stack((E, d, f), 1.0 / math.sqrt(d)),
        "wd": stack((E, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, f * cfg.n_shared_experts, mlp_type="swiglu", dtype=wdt,
                               device=device)
    return p


def _round8(c: int) -> int:
    return max(8, -(-c // 8) * 8)


def _capacity(cfg, S: int) -> int:
    E, K = cfg.n_experts, cfg.n_experts_per_token
    c = int(S * K / E * cfg.capacity_factor + 0.999)
    return min(_round8(c), S * K)


def moe_ffn(p, x, cfg, pctx, sharded: bool = False):
    """``x (B, S, d) -> (y (B, S, d), aux scalar)``.

    ``sharded`` says ``x`` is this rank's sequence shard (the training
    forward on a process group); otherwise ``x`` holds the global tokens
    (the virtual ring, and serving on either transport).  As in the JAX
    package the path follows from the *global* length: the all-to-all
    expert parallelism when it divides by the SP degree, else the
    replicated-sequence one; at SP 1 the dense capacity dispatch."""
    if pctx is not None and pctx.active:
        P = pctx.sp_degree
        S = x.shape[1] * (P if sharded and not pctx.ring.folded else 1)
        if S % P == 0:
            y, aux = _moe_ffn_a2a(p, x, cfg, pctx, sharded)
        else:
            y, aux = _moe_ffn_replicated_seq(p, x, cfg, pctx)
        if cfg.n_shared_experts:
            y = y + mlp(p["shared"], x, mlp_type="swiglu", compute_dtype=y.dtype)
        return y, aux
    return _moe_ffn_dense(p, x, cfg)


def _route(router_w, x, K):
    """float32 routing: ``(probs, expert_idx, gates)`` over the last dim."""
    logits = dense({"w": router_w}, x, torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(logits, K, dim=-1)
    return probs, expert_idx, torch.softmax(gate_vals, dim=-1)


def _positions(ids, n: int, valid=None):
    """Each entry's count of earlier entries with the same id (along dim 1);
    ``valid`` entries only, when given."""
    onehot = F.one_hot(ids, n).to(torch.int32)
    if valid is not None:
        onehot = onehot * valid[..., None]
    return ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)


def _scatter(shape, index, values, fill=0):
    """A new tensor of ``shape`` with one extra slot on the last indexed dim
    (where ``index`` sends what it drops), ``values`` summed in at
    ``index`` (set, for integer values), the extra slot sliced off."""
    n = len(index)
    full = list(shape)
    full[n - 1] += 1
    buf = torch.full(full, fill, dtype=values.dtype, device=values.device)
    buf = buf.index_put(index, values, accumulate=values.is_floating_point())
    return buf.narrow(n - 1, 0, shape[n - 1])


def _aux_loss(probs, expert_idx, E, K, dims, reduce=None):
    importance = probs.mean(dim=dims)  # (..., E)
    assigned = F.one_hot(expert_idx, E).float().sum(-2).mean(dim=dims)
    if reduce is not None:
        importance, assigned = reduce(importance), reduce(assigned)
    return E * (importance * assigned).sum(-1) / K


def _swiglu_experts(buf, wg, wu, wd, spec):
    """The experts' swiglu on a dispatch buffer: ``spec`` names the
    buffer's dims up to ``c`` (``"bec"``, ``"rec"``) over the weights'
    ``e`` (``"e"``, ``"re"``)."""
    bspec, wspec = spec
    g = torch.einsum(f"{bspec}d,{wspec}df->{bspec}f", buf, wg)
    u = torch.einsum(f"{bspec}d,{wspec}df->{bspec}f", buf, wu)
    return torch.einsum(f"{bspec}f,{wspec}fd->{bspec}d", F.silu(g) * u, wd)


def _moe_ffn_dense(p, x, cfg):
    """Single-device capacity dispatch."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.n_experts_per_token
    C = _capacity(cfg, S)
    dt = torch_dtype(cfg.dtype)

    probs, expert_idx, gates = _route(p["router"]["w"], x, K)
    flat_e = expert_idx.reshape(B, S * K)  # (B, T) entries, T = S*K
    pos = _positions(flat_e, E)
    keep = pos < C
    pos_c = torch.where(keep, pos, C - 1)

    xe = x[:, :, None, :].expand(B, S, K, d).reshape(B, S * K, d).to(dt)
    xe = xe * keep[..., None].to(dt)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = _scatter((B, E, C, d), (rows, flat_e, torch.where(keep, pos, C)), xe)

    yexp = _swiglu_experts(buf, p["wg"].to(dt), p["wu"].to(dt), p["wd"].to(dt), ("bec", "e"))
    y_ent = yexp[rows, flat_e, pos_c] * keep[..., None].to(dt)  # (B, T, d)
    y_ent = y_ent.reshape(B, S, K, d)
    y = torch.einsum("bskd,bsk->bsd", y_ent.float(), gates).to(dt)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x, mlp_type="swiglu", compute_dtype=dt)
    return y, _aux_loss(probs, expert_idx, E, K, (0, 1))


# ---------------------------------------------------------------------------
# expert parallelism over the ring
# ---------------------------------------------------------------------------


def _ep_ring(cfg, pctx):
    """``(ring, size)`` the experts shard over: every SP rank when E
    divides by the SP degree; else the inner axis of a podded ring (e.g.
    llama4's 16 experts on a ring wider than 16: experts replicated across
    pods, tokens routed within their pod)."""
    n_ep = ep_size(cfg.n_experts, pctx.sp_degree, pctx.pods)
    return (pctx.ring if n_ep == pctx.sp_degree else pctx.axis_rings[1]), n_ep


def ep_size(E: int, P: int, pods: int = 1) -> int:
    """The ranks :func:`_ep_ring` shards ``E`` experts over at SP degree
    ``P``."""
    if E % P == 0:
        return P
    if pods > 1 and E % (P // pods) == 0:
        return P // pods
    raise ValueError(f"experts {E} not shardable over an SP degree of {P} ({pods} pods)")


def _local_experts(p, n_ep, R, ring, dt):
    """Each (folded) rank's slice of the whole expert stacks, ``(R, E_loc,
    ...)``: EP rank ``r % n_ep`` of flat rank ``r`` (the inner index on a
    podded ring), the all-to-all's rank order."""
    def local(w):
        w = w.to(dt).reshape(n_ep, w.shape[0] // n_ep, *w.shape[1:])
        if not ring.folded:
            return w[ring.rank % n_ep][None]
        return w.repeat(R // n_ep, *([1] * (w.ndim - 1))) if R != n_ep else w
    return local(p["wg"]), local(p["wu"]), local(p["wd"])


def _ranked(x, pctx, sharded):
    """``x`` as ``(R, B, S_loc, d)``: every rank's contiguous sequence shard
    on the virtual ring; this rank's own on a process group (its slice of
    the replicated tokens unless ``sharded``)."""
    ring, P = pctx.ring, pctx.sp_degree
    if ring.folded:
        return ring.rank_view(fold_ranks(x, P))
    if sharded:
        return x[None]
    S_loc = x.shape[1] // P
    return x[None, :, ring.rank * S_loc:(ring.rank + 1) * S_loc]


def _unranked(y, pctx, sharded):
    """Inverse of :func:`_ranked`; on a process group the replicated tokens
    come back by an all-gather of every rank's slice."""
    ring, P = pctx.ring, pctx.sp_degree
    R, B, S_loc, d = y.shape
    if ring.folded:
        return unfold_ranks(y.reshape(R * B, S_loc, d), P)
    return y[0] if sharded else ring.all_gather(y[0], 1)


def _moe_ffn_a2a(p, x, cfg, pctx, sharded=False):
    """Expert-parallel MoE over the ring, per rank:

      1. local routing (router weights replicated);
      2. entries bucketed by destination EP rank (one-hot cumsum positions,
         per-destination capacity ``C_sd``), overflow dropped;
      3. one ``all_to_all`` ships the token buffer and the int32 table of
         each entry's expert at its destination; the int32 source-slot
         table stays at the source (the JAX code ships it too, but nothing
         reads what arrives, and XLA drops that exchange);
      4. local capacity dispatch (``C_e``) to this rank's ``E_loc`` experts;
      5. ``all_to_all`` back, combine at the source with the gates.

    ``C_sd = ceil(T_loc/P * capacity_factor)``, ``C_e = ceil(P*C_sd/E_loc *
    capacity_factor)``, each rounded up to 8.  Capacity is shared by every
    row of a rank: with a data axis, of a (data, SP) rank, sized from the
    data rank's local batch as the reference's ``Bl = x.shape[0]`` is (on
    the virtual mesh each folded rank's rows split into ``data_groups``
    routing groups, which the exchange keeps apart row by row).  The aux
    statistics are averaged over every rank, the ring's and the data
    axis's, before their product (a mean of products is not the product
    of means)."""
    E, K, d = cfg.n_experts, cfg.n_experts_per_token, x.shape[-1]
    dt = torch_dtype(cfg.dtype)
    ring, P = pctx.ring, pctx.sp_degree
    ep, Pn = _ep_ring(cfg, pctx)
    E_loc = E // Pn
    xr = _ranked(x, pctx, sharded)
    Rf, Bf, Sl = xr.shape[:3]
    groups = ring.data_groups
    xr = xr.reshape(Rf * groups, Bf // groups, Sl, d)
    R, Bl = xr.shape[:2]
    T = Bl * Sl * K
    C_sd = _round8(int(T / Pn * cfg.capacity_factor))
    C_e = _round8(int(Pn * C_sd / E_loc * cfg.capacity_factor))
    dev = x.device
    ranks = torch.arange(R, device=dev)[:, None]

    # 1. routing (float32)
    probs, expert_idx, gates = _route(p["router"]["w"], xr, K)
    flat_e = expert_idx.reshape(R, T)
    flat_g = gates.reshape(R, T)
    xe = xr.reshape(R, Bl * Sl, 1, d).expand(R, Bl * Sl, K, d).reshape(R, T, d).to(dt)

    # 2. destination buckets; dropped entries go to the overflow slot C_sd
    dest = torch.div(flat_e, E_loc, rounding_mode="floor")
    pos_d = _positions(dest, Pn)
    keep = pos_d < C_sd
    slot = (ranks, dest, torch.where(keep, pos_d, C_sd))
    send_x = _scatter((R, Pn, C_sd, d), slot, xe)
    send_e = _scatter((R, Pn, C_sd), slot, (flat_e % E_loc).to(torch.int32), fill=-1)
    src = torch.arange(T, device=dev, dtype=torch.int32).expand(R, T)
    send_s = _scatter((R, Pn, C_sd), slot, src, fill=-1)

    # 3. exchange: row q of what a rank receives came from EP rank q
    def a2a(t):
        return ep.all_to_all(t, 1, 1)

    recv_x, recv_e = a2a(send_x), a2a(send_e)
    Rr = Pn * C_sd
    rx, re = recv_x.reshape(R, Rr, d), recv_e.reshape(R, Rr)

    # 4. local capacity dispatch to E_loc experts
    valid = re >= 0
    re_c = torch.where(valid, re, 0).long()
    pos_e = _positions(re_c, E_loc, valid.to(torch.int32))
    keep_e = valid & (pos_e < C_e)
    buf = _scatter((R, E_loc, C_e, d), (ranks, re_c, torch.where(keep_e, pos_e, C_e)), rx)
    wg, wu, wd = (w.repeat_interleave(groups, 0) if groups > 1 else w
                  for w in _local_experts(p, Pn, Rf, ring, dt))
    yb = _swiglu_experts(buf, wg, wu, wd, ("rec", "re"))
    y_ent = yb[ranks, re_c, torch.where(keep_e, pos_e, C_e - 1)] * keep_e[..., None].to(dt)

    # 5. return trip: entries sent to EP rank q come back at the same
    # (q, slot) positions, so the send_s table maps them home
    y_recv = a2a(y_ent.reshape(R, Pn, C_sd, d)).reshape(R, Rr, d)
    flat_slot = send_s.reshape(R, Rr).long()
    y_tok = _scatter((R, T, d), (ranks, torch.where(flat_slot >= 0, flat_slot, T)), y_recv)
    y = (y_tok.float() * flat_g[..., None]).reshape(R, Bl * Sl, K, d).sum(2)
    y = _unranked(y.reshape(Rf, Bf, Sl, d).to(dt), pctx, sharded)

    def pmean(t):  # over every rank of the mesh: (R, E) -> (1, E)
        t = ring.all_reduce(t, "sum") / P  # (groups, E)
        if groups > 1:
            t = t.mean(0, keepdim=True)
        elif pctx.data is not None and not ring.folded and pctx.data_degree > 1:
            t = pctx.data.all_reduce(t, "sum") / pctx.data_degree
        return t

    aux = _aux_loss(probs, expert_idx, E, K, (1, 2), reduce=pmean)
    return y, aux[0]


def _ep_slices(p, n_ep, pctx, dt, device):
    """``(index, wg, wu, wd)``: the EP slices of ``E / n_ep`` experts that
    this process runs in the replicated-sequence path, ``(k, E_loc, ...)``
    each, and their EP indices ``(k,)``: every slice in EP order on the
    virtual ring (``k = n_ep``), this rank's on a process group (``k = 1``).

    A model block of ``E / G`` experts (``G = P / pods`` the inner ranks)
    holds ``s = n_ep / G`` EP slices (``pods`` where EP runs over every SP
    rank, else 1), and flat rank ``(pod q, inner i)`` runs EP slice ``e = i
    * s + q % s``: on serve storage a part of its own block, so no expert
    weight moves (module docstring)."""
    ring, P = pctx.ring, pctx.sp_degree
    G = P // pctx.pods
    s = n_ep // G
    if ring.folded:
        index = torch.arange(n_ep, device=device)
    else:
        q, i = divmod(ring.rank, G)
        e = i * s + q % s
        index = torch.tensor([e], device=device)

    def local(w):
        if not isinstance(w, ServeBlocks):
            w = w.to(dt).reshape(n_ep, w.shape[0] // n_ep, *w.shape[1:])
            return w if ring.folded else w[e:e + 1]
        E, b = w.shape[0], w.blocks
        if w.split != 0 or b.shape[1] * G != E:
            raise ValueError(f"serve blocks {w.spec} of an expert stack {w.shape} are not split "
                             f"by expert over the {G} model ranks: EP slice e of {n_ep} "
                             f"({E // n_ep} experts) must lie in model block e // {s}")
        if ring.folded:
            return b.reshape(n_ep, E // n_ep, *b.shape[2:]).to(dt)
        n = E // n_ep
        return b.narrow(1, e % s * n, n).to(dt)

    return (index, *(local(p[k]) for k in ("wg", "wu", "wd")))


def _moe_ffn_replicated_seq(p, x, cfg, pctx):
    """Expert parallelism for tokens that do not shard over the ring
    (decode, S = 1): every rank sees every token, runs the entries routed
    to its own experts (:func:`_ep_slices`), and the contributions are
    summed over the EP ranks (payload one ``(B, S, d)`` tensor).  On the
    virtual ring the slices are computed once each, in EP order, and each
    rank of a pod's inner ring takes its slice's (EP over ``model`` only,
    replicated over pods).  Its aux is 0, as in the JAX package."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.n_experts_per_token
    dt = torch_dtype(cfg.dtype)
    ring = pctx.ring
    ep, Pn = _ep_ring(cfg, pctx)
    E_loc = E // Pn
    T = B * S * K
    C_e = _round8(int(T / E_loc * cfg.capacity_factor))
    dev = x.device
    ep_rank, wg, wu, wd = _ep_slices(p, Pn, pctx, dt, dev)
    R = ep_rank.shape[0]
    ranks = torch.arange(R, device=dev)[:, None]

    _, expert_idx, gates = _route(p["router"]["w"], x, K)
    flat_e = expert_idx.reshape(1, T).expand(R, T)
    flat_g = gates.reshape(1, T)
    xe = x.reshape(B * S, 1, d).expand(B * S, K, d).reshape(1, T, d).expand(R, T, d).to(dt)

    mine = torch.div(flat_e, E_loc, rounding_mode="floor") == ep_rank[:, None]
    le = torch.where(mine, flat_e % E_loc, 0)
    pos = _positions(le, E_loc, mine.to(torch.int32))
    keep = mine & (pos < C_e)
    buf = _scatter((R, E_loc, C_e, d), (ranks, le, torch.where(keep, pos, C_e)), xe)
    yb = _swiglu_experts(buf, wg, wu, wd, ("rec", "re"))
    y_ent = yb[ranks, le, torch.where(keep, pos, C_e - 1)] * keep[..., None].to(dt)
    y = (y_ent.float() * flat_g[..., None]).reshape(R, B * S, K, d).sum(2)
    if ring.folded and R != ring.folded_ranks:  # rank (pod, inner i) holds slice i's
        y = y[None].expand(ring.folded_ranks // R, *y.shape).flatten(0, 1)
    y = ep.all_reduce(y.reshape(-1, S, d), "sum")  # (pods*B, S, d): one block a pod
    return y[:B].to(dt), torch.zeros((), dtype=torch.float32, device=dev)

"""Functional layer primitives (port of ``repro.models.layers``).

Parameters are plain nested dicts of tensors.  Compute runs in
``cfg.dtype`` with float32 norms, RoPE and softmax, as in the JAX package.

Dtype note: the JAX package stores every parameter in ``cfg.param_dtype``
and ``dense()`` casts the weights to the compute dtype on every call.  The
port has two storage layouts, chosen by the ``training`` argument of
``transformer.init_lm`` and ``convert.from_jax_params``:

* training (``training=True``, what the trainer and the training tests
  pass): every leaf in ``cfg.param_dtype``, as the JAX tree, so AdamW updates
  the float32 values and ``dense()`` casts them on each call;
* serving (the default): the cast is made once, at load: dense weights and
  the embedding table in ``cfg.dtype``, norm scales in ``cfg.param_dtype``.
  Casting once or on every call rounds the same values to the same numbers,
  so the forward results are identical.

Serve storage (``repro_torch.sharding.ServeBlocks`` leaves, the decode
step's Megatron layout) runs on the blocks, leaf by leaf as the rule split
them, through the mesh transport's tensor-parallel collectives
(``core/collectives.py``): a weight split by columns is a local product on
each rank's block, its bias (split alike) added to the slice, then an
activation all-gather; a weight split by rows takes each rank's slice of
its input, then a sum all-reduce, and its bias whole.  :func:`mlp` keeps
a column pair's product split into its row-split output projection
(Megatron's pairing: one all-reduce, no gather).  A 1-D leaf that the
layer needs whole (a norm scale, a row projection's bias) is gathered.
The embedding lookup follows its table's split: by ``d`` a local lookup
then a gather, by vocabulary a masked lookup then a sum.

The recurrent layers' decode state is split by its width over the
sequence axes (``sharding.serve_state_shardings``: ``d_inner``, ``lru``
over ``model``, or ``("pod", "model")`` on the pod mesh), so their
per-channel work runs on the ranks' slices, ranked ``(k, ...)`` as the
transports rank them (``k`` the state's ``K`` slices on the virtual mesh,
1 on a process group): :func:`state_tp` is the transport of such a state
(one rank's, :data:`ONE_RANK`, where nothing is split), :func:`dense_split_out`
a product left split by its output columns (a column-split weight's own
products, no collective), :func:`dense_split_in` a product of an input
that arrives split (a row-split weight's partials summed, any other
weight's input gathered first), :func:`tp_slices` the ranks' slices of a
leaf (gathered whole first where the rule splits it on another dim).  On
the pod mesh the state has ``K = pods * G`` slices against the weights'
``G`` blocks, ranked model-major (``core.collectives.SeqAxesTP``), so a
split weight's slice for a rank is a part of its own block and no weight
moves.  :class:`TPBytes` holds the closed forms of these ops' bytes, which
the decode steps' ``*serve_comm_bytes`` sum.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import SeqAxesTP
from repro_torch.sharding import ServeBlocks, serve_split, tree_bytes

__all__ = [
    "torch_dtype",
    "dense_init",
    "dense",
    "norm_init",
    "apply_norm",
    "embed_init",
    "embed_lookup",
    "apply_rope",
    "mlp_init",
    "mlp",
    "tp_pair",
    "ONE_RANK",
    "state_tp",
    "held_ranks",
    "tp_slices",
    "dense_split_out",
    "dense_split_in",
    "TPBytes",
    "comm_classes",
    "chunked_cross_entropy",
    "lm_cross_entropy",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False, dtype="float32",
               device="cuda", scale: float | None = None):
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device, dtype=torch.float32) * scale
    p = {"w": w.to(torch_dtype(dtype))}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch_dtype(dtype), device=device)
    return p


def dense(p, x, compute_dtype):
    """``x @ w (+ b)`` in ``compute_dtype``; ``w`` is ``(d_in, d_out)``, a
    tensor or serve blocks (module docstring)."""
    if isinstance(p["w"], ServeBlocks):
        x2 = x.reshape(-1, x.shape[-1])
        if p["w"].split == 1:
            y = p["w"].transport().tp_gather(_column_parts(p, x2, compute_dtype), -1)
            if "b" in p and not isinstance(p["b"], ServeBlocks):
                y = y + p["b"].to(compute_dtype)
        else:
            y = _row_sum(p, p["w"].transport().tp_split(x2, -1), compute_dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def whole(t):
    """A leaf as the full tensor: serve blocks gathered."""
    return t.whole() if isinstance(t, ServeBlocks) else t


def _held(t, dim: int, comm):
    """The blocks of serve leaf ``t`` split along ``dim`` as ``comm``'s
    slices (``core.collectives``' ``sub_blocks``); ``comm`` ``None``: the
    leaf's own transport, its model blocks."""
    return t.blocks if comm is None else comm.sub_blocks(t.blocks, dim)


def _column_parts(p, x2, compute_dtype, comm=None):
    """``x2 (M, d_in) @`` each block of a column-split ``w`` (each of
    ``comm``'s slices of it), ranked ``(k, M, n / k)``, with the bias's
    matching slice where it is split alike."""
    y = x2.to(compute_dtype) @ _held(p["w"], 1, comm).to(compute_dtype)
    if isinstance(p.get("b"), ServeBlocks):
        y = y + _held(p["b"], 0, comm).to(compute_dtype)[:, None, :]
    return y


def _row_sum(p, parts, compute_dtype, comm=None):
    """Ranked input slices ``(k, M, d_in / k)`` through a row-split ``w``:
    the partial products summed over the ranks of ``comm`` (``None``: the
    weight's own, ``model``), then the bias whole."""
    w = p["w"]
    y = (comm or w.transport()).tp_sum(parts.to(compute_dtype)
                                       @ _held(w, 0, comm).to(compute_dtype))
    if "b" in p:
        y = y + whole(p["b"]).to(compute_dtype)
    return y


def tp_pair(col_splits, row_split) -> bool:
    """Whether products whose weights split at the dims ``col_splits`` feed
    one split at ``row_split`` with no gather between: Megatron's pair,
    every column weight split by columns and the row weight by rows."""
    return all(s == 1 for s in col_splits) and row_split == 0


def _split(w):
    return w.split if isinstance(w, ServeBlocks) else None


def _tp_pair(col_ps, row_p) -> bool:
    return tp_pair([_split(q["w"]) for q in col_ps], _split(row_p["w"]))


class OneRank:
    """The tensor-parallel collectives of one model rank (no mesh, or a
    model axis of 1): a tensor's one slice is itself, ranked ``(1, ...)``."""

    folded = True
    tp_size = 1

    def tp_split(self, x, dim: int):
        return x[None]

    def tp_gather(self, parts, dim: int):
        return parts[0]

    def tp_sum(self, parts):
        return parts[0]


ONE_RANK = OneRank()


def state_tp(pctx):
    """The transport of a decode state that serve storage splits by its
    width over the sequence axes (module docstring): on a ``(data, model)``
    mesh the context's mesh transport where its model axis has more than
    one rank, else :data:`ONE_RANK`; on the pod mesh a
    ``core.collectives.SeqAxesTP`` over ``("pod", "model")``.

    The reference's spec ``("pod", "model")`` orders the slices pod-major
    (rank ``(p, m)`` holds slice ``p * G + m``), which would have a rank
    read weight rows of another model rank at every step.  The port keeps
    that spec and orders them model-major, rank ``(p, m)`` holding slice
    ``m * pods + p`` (ROADMAP queue 3 item 13): each rank's slice is a part
    of its model rank's share, every weight slice it needs is in its own
    block, and the state gathered back is the reference's."""
    comm = getattr(pctx, "storage", None)
    if comm is not None and pctx.pods > 1:
        return SeqAxesTP(comm)
    if comm is None or comm.tp_size == 1:
        return ONE_RANK
    return comm


def held_ranks(comm) -> int:
    """How many ranks' slices a process holds: every model rank's on the
    virtual mesh, its own on a process group."""
    return comm.tp_size if comm.folded else 1


def tp_slices(t, dim: int, comm):
    """The ranks' slices ``(k, ...)`` of leaf ``t`` along ``dim``: serve
    blocks split on ``dim`` are their blocks; split on another dim they are
    gathered whole first (counted); a whole tensor is sliced."""
    if isinstance(t, ServeBlocks) and t.split == dim % len(t.shape):
        return _held(t, dim % len(t.shape), comm)
    return comm.tp_split(whole(t), dim)


def dense_split_out(p, x, compute_dtype, comm):
    """``dense(p, x)`` left split by its output columns, the ranks' slices
    ``(k, *x.shape[:-1], n / G)``: a column-split weight's own products (no
    collective); any other weight's whole output, sliced."""
    if isinstance(p["w"], ServeBlocks) and p["w"].split == 1:
        y = _column_parts(p, x.reshape(-1, x.shape[-1]), compute_dtype, comm)
        return y.reshape(y.shape[0], *x.shape[:-1], y.shape[-1])
    return comm.tp_split(dense(p, x, compute_dtype), -1)


def dense_split_in(p, parts, compute_dtype, comm):
    """``dense(p, x)`` of an input that arrives as the ranks' slices ``parts
    (k, ..., d_in / G)``: a row-split weight sums its partial products (one
    all-reduce); any other weight takes the input gathered whole."""
    if isinstance(p["w"], ServeBlocks) and p["w"].split == 0:
        y = _row_sum(p, parts.reshape(parts.shape[0], -1, parts.shape[-1]), compute_dtype, comm)
        return y.reshape(*parts.shape[1:-1], y.shape[-1])
    return dense(p, comm.tp_gather(parts, -1), compute_dtype)


class TPBytes:
    """Closed forms of the ops above on serve blocks: the ledger's ``"tp"``
    bytes a rank and direction (the transports' conventions,
    ``core/collectives.py``) of one call, on the serve layout's ``mesh``,
    ``rows`` the rows one rank's step carries, ``e`` the compute dtype's
    itemsize.  With ``G`` the model size and ``n`` a tensor's bytes whole,
    a gather of its slices moves ``(G-1) * n/G / 2``, a sum ``(G-1)/G * n``;
    a recurrent state's split input gathers and sums over its ``K = pods *
    G`` ranks alike (:meth:`state_gathered`, :meth:`state_summed`).
    Widths are bytes a row."""

    def __init__(self, mesh, rows: int, e: int):
        self.mesh, self.rows, self.e = mesh, rows, e
        self.G = mesh.shape["model"]
        self.K = self.G * mesh.shape.get("pod", 1)

    def split(self, spec):
        return serve_split(spec, self.mesh)

    def gathered(self, n):
        return (self.G - 1) * n / self.G / 2

    def summed(self, n):
        return (self.G - 1) / self.G * n

    def state_gathered(self, n):
        """A gather of a recurrent state's ``K`` slices (:func:`state_tp`)."""
        return (self.K - 1) * n / self.K / 2

    def state_summed(self, n):
        return (self.K - 1) / self.K * n

    def whole(self, spec, meta):
        """:func:`whole` of a leaf."""
        return 0.0 if self.split(spec) is None else self.gathered(tree_bytes(meta))

    def norm(self, specs, meta):
        return sum(self.whole(specs[k], meta[k]) for k in specs)

    def slices(self, spec, meta, dim: int):
        """:func:`tp_slices` of a leaf."""
        return 0.0 if self.split(spec) in (None, dim) else self.gathered(tree_bytes(meta))

    def product(self, specs, meta, out_bytes, transpose=False):
        """:func:`dense` (of ``w.T`` with ``transpose``)."""
        s = self.split(specs["w"][::-1] if transpose else specs["w"])
        if s is None:
            return 0.0
        if s == 1:
            return self.gathered(self.rows * out_bytes)
        return (self.summed(self.rows * out_bytes)
                + (self.whole(specs["b"], meta["b"]) if "b" in specs else 0.0))

    def split_out(self, specs, meta, out_bytes):
        """:func:`dense_split_out`."""
        return 0.0 if self.split(specs["w"]) == 1 else self.product(specs, meta, out_bytes)

    def split_in(self, specs, meta, in_bytes, out_bytes):
        """:func:`dense_split_in` of an input split as the state is."""
        if self.split(specs["w"]) == 0:
            return self.state_summed(self.rows * out_bytes) + (
                self.whole(specs["b"], meta["b"]) if "b" in specs else 0.0)
        return self.state_gathered(self.rows * in_bytes) + self.product(specs, meta, out_bytes)

    def ffn(self, specs, meta, d: int, f: int):
        """:func:`mlp` of widths ``d`` and ``f``."""
        keys = ("gate", "up", "down") if "gate" in specs else ("in", "out")
        *cols, row = keys
        if tp_pair([self.split(specs[k]["w"]) for k in cols], self.split(specs[row]["w"])):
            return self.summed(self.rows * d * self.e) + (
                self.whole(specs[row]["b"], meta[row]["b"]) if "b" in specs[row] else 0.0)
        return (sum(self.product(specs[k], meta[k], f * self.e) for k in cols)
                + self.product(specs[row], meta[row], d * self.e))

    def embed(self, spec, meta):
        """:func:`embed_lookup` of a ``(rows, d)`` table's rows."""
        row = self.rows * meta.shape[1] * meta.element_size()
        return {None: 0.0, 1: self.gathered(row), 0: self.summed(row)}[self.split(spec)]

    def attention(self, specs, meta, cfg, keys=("wq", "wk", "wv", "wo")):
        """The projections ``keys`` of an attention layer (``models.attention``)
        and its q/k norms."""
        Hq, Hkv, Dh, e = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, self.e
        width = {"wq": Hq * Dh * e, "wk": Hkv * Dh * e, "wv": Hkv * Dh * e, "wo": cfg.d_model * e}
        return (sum(self.product(specs[k], meta[k], width[k]) for k in keys)
                + sum(self.norm(specs[k], meta[k]) for k in ("q_norm", "k_norm") if k in specs))

    def head(self, layout, cfg):
        """The output head: ``lm_head`` or the tied ``embed.table.T``."""
        if "lm_head" in layout.specs:
            return self.product(layout.specs["lm_head"], layout.meta["lm_head"],
                                cfg.vocab_size * self.e)
        return self.product({"w": layout.specs["embed"]["table"]}, {}, cfg.vocab_size * self.e,
                            transpose=True)


def comm_classes(tp: float, link: float, intra: float = 0.0) -> dict[str, dict[str, float]]:
    """A decode step's bytes by link class, both directions alike;
    ``"data"`` is nothing: serve storage replicates every leaf over the
    data axis; ``"intra"`` (the pod mesh's inner ring) only where it moves
    bytes."""
    out = {cls: {"fwd": n, "bwd": n} for cls, n in (("tp", tp), ("link", link), ("data", 0.0))}
    if intra:
        out["intra"] = {"fwd": intra, "bwd": intra}
    return out


def norm_init(d: int, *, norm_type: str = "rmsnorm", dtype="float32", device="cuda"):
    dt = torch_dtype(dtype)
    if norm_type == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dt, device=device)}
    if norm_type == "layernorm":
        return {"scale": torch.ones((d,), dtype=dt, device=device),
                "bias": torch.zeros((d,), dtype=dt, device=device)}
    if norm_type == "nonparam_ln":
        return {}
    raise ValueError(norm_type)


def apply_norm(p, x, *, norm_type: str = "rmsnorm", eps: float = 1e-6):
    xf = x.float()
    if norm_type == "rmsnorm":
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * whole(p["scale"]).float()
    elif norm_type in ("layernorm", "nonparam_ln"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if norm_type == "layernorm":
            y = y * whole(p["scale"]).float() + whole(p["bias"]).float()
    else:
        raise ValueError(norm_type)
    return y.to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype="float32", device="cuda"):
    t = torch.randn((vocab, d), generator=gen, device=device, dtype=torch.float32) * 0.02
    return {"table": t.to(torch_dtype(dtype))}


def embed_lookup(table, ids):
    """``table[ids]``; serve blocks split by ``d`` look up each block then
    gather, split by vocabulary look up the rows each rank holds (zero
    elsewhere) then sum."""
    if not isinstance(table, ServeBlocks):
        return table[ids]
    comm, blocks = table.transport(), table.blocks
    if table.split == 1:
        return comm.tp_gather(blocks[:, ids], -1)
    n = blocks.shape[1]
    local = ids[None] - (comm.tp_ranks(ids.device) * n).reshape(-1, *([1] * ids.ndim))
    held = (local >= 0) & (local < n)
    ranks = torch.arange(blocks.shape[0], device=ids.device).reshape(-1, *([1] * ids.ndim))
    rows = blocks[ranks, torch.where(held, local, 0)]
    return comm.tp_sum(rows * held[..., None].to(rows.dtype))


def apply_rope(x, positions, theta: float):
    """Rotate-half RoPE in float32.  ``x (B,S,H,D)``, ``positions (B,S)``."""
    D = x.shape[-1]
    half = D // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)


def mlp_init(gen, d: int, f: int, *, mlp_type: str = "swiglu", dtype="float32",
             device="cuda"):
    if mlp_type == "swiglu":
        return {
            "gate": dense_init(gen, d, f, dtype=dtype, device=device),
            "up": dense_init(gen, d, f, dtype=dtype, device=device),
            "down": dense_init(gen, f, d, dtype=dtype, device=device),
        }
    if mlp_type == "gelu":
        return {
            "in": dense_init(gen, d, f, bias=True, dtype=dtype, device=device),
            "out": dense_init(gen, f, d, bias=True, dtype=dtype, device=device),
        }
    raise ValueError(mlp_type)


def mlp(p, x, *, mlp_type: str = "swiglu", compute_dtype=torch.bfloat16):
    if mlp_type == "swiglu" and _tp_pair((p["gate"], p["up"]), p["down"]):
        x2 = x.reshape(-1, x.shape[-1])
        h = F.silu(_column_parts(p["gate"], x2, compute_dtype)) * _column_parts(
            p["up"], x2, compute_dtype)
        return _row_sum(p["down"], h, compute_dtype).reshape(x.shape)
    if mlp_type == "gelu" and _tp_pair((p["in"],), p["out"]):
        x2 = x.reshape(-1, x.shape[-1])
        h = F.gelu(_column_parts(p["in"], x2, compute_dtype), approximate="tanh")
        return _row_sum(p["out"], h, compute_dtype).reshape(x.shape)
    if mlp_type == "swiglu":
        g = dense(p["gate"], x, compute_dtype)
        u = dense(p["up"], x, compute_dtype)
        return dense(p["down"], F.silu(g) * u, compute_dtype)
    if mlp_type == "gelu":
        h = F.gelu(dense(p["in"], x, compute_dtype), approximate="tanh")
        return dense(p["out"], h, compute_dtype)
    raise ValueError(mlp_type)


def _chunk_ce_sum(xb, w, lb, mb, compute_dtype):
    """Summed masked CE of one ``(B, chunk)`` slice of the sequence."""
    logits = (xb.to(compute_dtype) @ w).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lb.long()[..., None])[..., 0]
    return ((lse - gold) * mb).sum()


def chunked_cross_entropy(x, w_lm, labels, *, mask=None, chunk: int = 1024,
                          compute_dtype=torch.bfloat16):
    """Mean CE of ``softmax(x @ w_lm)`` vs labels, computed in seq chunks.

    ``x (B,S,d)``, ``w_lm (d,V)``, ``labels (B,S)``, optional ``mask (B,S)``.
    Only ``(B, chunk, V)`` logits exist at a time.  With grad enabled each
    chunk is checkpointed: its logits are recomputed in the backward instead
    of kept (about 10 GB at vocab 151936, batch 2 x 4096), with the same
    values.  Returns ``(mean_loss, total_weight)``.
    """
    B, S, _ = x.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    w = w_lm.to(compute_dtype)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    wsum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        xb, lb, mb = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            ce = checkpoint(_chunk_ce_sum, xb, w, lb, mb, compute_dtype, use_reentrant=False)
        else:
            ce = _chunk_ce_sum(xb, w, lb, mb, compute_dtype)
        tot = tot + ce
        wsum = wsum + mb.sum()
    return tot / torch.clamp(wsum, min=1.0), wsum


def lm_cross_entropy(x, w_lm, labels, *, mask=None, chunk: int = 1024,
                     compute_dtype=torch.bfloat16):
    """LM-head cross entropy (single device: the chunked path)."""
    return chunked_cross_entropy(x, w_lm, labels, mask=mask, chunk=chunk,
                                 compute_dtype=compute_dtype)

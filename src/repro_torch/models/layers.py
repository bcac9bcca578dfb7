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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import ServeBlocks

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


def _column_parts(p, x2, compute_dtype):
    """``x2 (M, d_in) @`` each block of a column-split ``w``, ranked ``(k, M,
    n / G)``, with the bias's matching slice where it is split alike."""
    y = x2.to(compute_dtype) @ p["w"].blocks.to(compute_dtype)
    if isinstance(p.get("b"), ServeBlocks):
        y = y + p["b"].blocks.to(compute_dtype)[:, None, :]
    return y


def _row_sum(p, parts, compute_dtype):
    """Ranked input slices ``(k, M, d_in / G)`` through a row-split ``w``:
    the partial products summed over ``model``, then the bias whole."""
    w = p["w"]
    y = w.transport().tp_sum(parts.to(compute_dtype) @ w.blocks.to(compute_dtype))
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

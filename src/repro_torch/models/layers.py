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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = [
    "torch_dtype",
    "dense_init",
    "dense",
    "norm_init",
    "apply_norm",
    "embed_init",
    "apply_rope",
    "mlp_init",
    "mlp",
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
    """``x @ w (+ b)`` in ``compute_dtype``; ``w`` is ``(d_in, d_out)``."""
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


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
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    elif norm_type in ("layernorm", "nonparam_ln"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if norm_type == "layernorm":
            y = y * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(norm_type)
    return y.to(x.dtype)


def embed_init(gen, vocab: int, d: int, dtype="float32", device="cuda"):
    t = torch.randn((vocab, d), generator=gen, device=device, dtype=torch.float32) * 0.02
    return {"table": t.to(torch_dtype(dtype))}


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

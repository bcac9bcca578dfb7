"""Functional layer primitives (port of ``repro.models.layers``).

Parameters are plain nested dicts of tensors.  Compute runs in
``cfg.dtype`` with float32 norms, RoPE and softmax, as in the JAX package.

Dtype note: the JAX package stores parameters in ``cfg.param_dtype`` and
``dense()`` casts the weights to the compute dtype on every call.  The port
makes that cast once, at load (:func:`init_lm` / ``convert.from_jax_params``
store dense weights and the embedding table in ``cfg.dtype``; norm scales
stay in ``cfg.param_dtype``).  Casting once or on every call rounds the same
values to the same numbers, so the results are identical.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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

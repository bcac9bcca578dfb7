"""Model-level attention: projections + RoPE + the attention core (port of
``repro.models.attention``): :func:`attention` is the training path, the
others are the serving entry points.

The JAX serving functions return new cache arrays; here the cache tensors are
updated in place (``index_put_`` through a drop plan, see
``serving.kv_cache.drop_plan``) and the functions return only ``y``.
Each write happens after the layer's attention has read the pre-write
cache, exactly where the JAX code writes.

The caches (and gathered page views) come in the layout of the context's
ring (``serving.kv_cache``), which the serving entry points take as is:
rank-major on the virtual ring; this rank's shard on a process group, where
the drop plans keep only the writes the rank holds.
``table_pages`` (block-table width) rides into the plans' cost term.
"""

from __future__ import annotations

from repro_torch.core.api import (
    ParallelContext,
    sp_attention,
    sp_decode,
    sp_decode_paged,
    sp_prefill,
)
from repro_torch.models.layers import (
    apply_norm,
    apply_rope,
    dense,
    dense_init,
    norm_init,
    torch_dtype,
)
from repro_torch.serving.kv_cache import apply_drop, gather_pages

__all__ = [
    "attention_init",
    "attention",
    "attention_prefill_chunk",
    "attention_prefill_chunk_paged",
    "attention_decode",
    "attention_decode_paged",
]


def attention_init(gen, cfg, device="cuda", training: bool = False):
    """Projection weights in ``cfg.dtype`` (serving) or ``cfg.param_dtype``
    (``training``), see ``models.layers``; norm scales in ``cfg.param_dtype``."""
    d, Hq, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wdt = cfg.param_dtype if training else cfg.dtype
    kw = dict(bias=cfg.qkv_bias, dtype=wdt, device=device)
    p = {
        "wq": dense_init(gen, d, Hq * Dh, **kw),
        "wk": dense_init(gen, d, Hkv * Dh, **kw),
        "wv": dense_init(gen, d, Hkv * Dh, **kw),
        "wo": dense_init(gen, Hq * Dh, d, dtype=wdt, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(Dh, dtype=cfg.param_dtype, device=device)
        p["k_norm"] = norm_init(Dh, dtype=cfg.param_dtype, device=device)
    return p


def _project_qkv(p, x, positions, cfg):
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = torch_dtype(cfg.dtype)
    q = dense(p["wq"], x, dt).reshape(B, S, Hq, Dh)
    k = dense(p["wk"], x, dt).reshape(B, S, Hkv, Dh)
    v = dense(p["wv"], x, dt).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, norm_type="rmsnorm", eps=cfg.norm_eps)
        k = apply_norm(p["k_norm"], k, norm_type="rmsnorm", eps=cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, out, cfg):
    B, S = out.shape[:2]
    return dense(p["wo"], out.reshape(B, S, -1), torch_dtype(cfg.dtype))


def attention(p, x, positions, *, cfg, pctx: ParallelContext, window: int | None = None,
              causal: bool | None = None):
    """Self-attention over ``x (B,S,d)`` with global ``positions (B,S)``:
    the training path, no cache."""
    causal = cfg.causal if causal is None else causal
    q, k, v = _project_qkv(p, x, positions, cfg)
    out = sp_attention(q, k, v, positions, positions, pctx=pctx, causal=causal, window=window)
    return _out_proj(p, out, cfg)


def attention_prefill_chunk(p, x, positions, k_cache, v_cache, pos_cache, write_plan, *,
                            cfg, pctx: ParallelContext, window: int | None = None):
    """Chunked-prefill step against one layer's dense cache ``(B,Smax,Hkv,D)``.

    ``pos_cache (B,Smax)`` is the *pre-chunk* position table; ``write_plan``
    the drop plan of the chunk's ``(row, slot)`` writes.  The chunk attends
    to the resident cache and to itself; its K/V land afterwards."""
    q, k, v = _project_qkv(p, x, positions, cfg)
    out = sp_prefill(q, k, v, positions, k_cache, v_cache, pos_cache, positions,
                     pctx=pctx, window=window)
    apply_drop(k_cache, write_plan, k)
    apply_drop(v_cache, write_plan, v)
    return _out_proj(p, out, cfg)


def attention_decode(p, x, positions, k_cache, v_cache, pos_cache, write_plan, *, cfg,
                     pctx: ParallelContext, window: int | None = None):
    """Decode step ``x (B,1,d)``: write the new K/V, then attend over the
    cache; ``pos_cache`` already holds this step's positions."""
    q, k, v = _project_qkv(p, x, positions, cfg)
    apply_drop(k_cache, write_plan, k[:, 0])
    apply_drop(v_cache, write_plan, v[:, 0])
    out = sp_decode(q, k_cache, v_cache, pos_cache, positions, pctx=pctx, window=window)
    return _out_proj(p, out, cfg)


def attention_decode_paged(p, x, positions, k_pool, v_pool, pos_pool, block_tables, lengths,
                           write_plan, *, cfg, pctx: ParallelContext,
                           window: int | None = None, table_pages: int | None = None):
    """Paged decode step ``x (B,1,d)`` against one layer's pools
    ``(n_pages,ps,Hkv,D)``.  The new K/V scatter into the pool first; the
    attention reads the pool through the block table (kernel C on CUDA,
    the lengths-clamped gather oracle on the plain path)."""
    q, k, v = _project_qkv(p, x, positions, cfg)
    apply_drop(k_pool, write_plan, k[:, 0])
    apply_drop(v_pool, write_plan, v[:, 0])
    out = sp_decode_paged(q, k_pool, v_pool, pos_pool, block_tables, positions, lengths,
                          pctx=pctx, window=window, table_pages=table_pages)
    return _out_proj(p, out, cfg)


def attention_prefill_chunk_paged(p, x, positions, k_pool, v_pool, old_pos_view, flat_view,
                                  write_plan, *, cfg, pctx: ParallelContext,
                                  window: int | None = None, table_pages: int | None = None):
    """Paged chunked-prefill step: the chunk against the gathered view of
    its resident pages (positions from the *pre-chunk* pool; each rank's
    own pages with ``sp_degree > 1``), then its K/V scatter into the owned
    pages."""
    q, k, v = _project_qkv(p, x, positions, cfg)
    k_view = gather_pages(k_pool, flat_view)
    v_view = gather_pages(v_pool, flat_view)
    out = sp_prefill(q, k, v, positions, k_view, v_view, old_pos_view, positions,
                     pctx=pctx, window=window, table_pages=table_pages)
    apply_drop(k_pool, write_plan, k)
    apply_drop(v_pool, write_plan, v)
    return _out_proj(p, out, cfg)

"""Carry parameters of the JAX ``init_lm``, ``init_encdec``,
``init_mamba_lm`` and ``init_rg`` pytrees across to the port.

The JAX tree stacks the layers on a leading L dim and stores dense weights
as ``(d_in, d_out)``, as the port does; tied embeddings need no ``lm_head``.
A MoE layer's ``"moe"`` subtree (``router.w``, the ``(E, d, f)`` stacks
``wg``/``wu`` and ``(E, f, d)`` ``wd``, the ``shared`` expert) comes across
with the layer's index taken from each stack.  An encoder-decoder tree
(``embed``, ``dec_pos``, the stacked ``enc_layers`` and ``dec_layers`` with
their ``self``/``cross``/``ln_x``, ``enc_norm``, ``dec_norm``) unstacks
both layer stacks.  A mamba tree's stacked ``layers`` (``norm``,
``in_proj``, ``conv_w (K, di)``, ``conv_b``, ``x_proj``, ``dt_proj`` with
its bias, ``A_log (di, N)``, ``D``, ``out_proj``) unstack like a
transformer's, and its untied ``lm_head`` comes across.  A hybrid
(recurrentgemma) tree's stacked ``supers`` (``rec1``/``mlp1``/``rec2``/
``mlp2``/``attn``/``mlp3``) and ``tail`` (``rec``/``mlp``) unstack into
lists; a recurrent block's gates ``gate_a``/``gate_i`` compute in
float32 and keep ``cfg.param_dtype`` in the serving layout, as do
``lam``, ``conv_w``, ``conv_b`` and the norms.
The input is the tree with numpy leaves (``jax.tree.map(np.asarray,
params)``), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import torch_dtype

__all__ = ["from_jax_params"]

# Leaves the serving layout stores in the compute dtype (cast once at load,
# see models.layers), the MoE expert stacks included; every other leaf (norm
# scale/bias, mamba's conv, A_log and D, the RG-LRU's conv and lam, and the
# subtrees that compute in float32 as the JAX code does: the MoE router,
# mamba's dt_proj and the RG-LRU's gates), and every leaf of the training
# layout, keeps cfg.param_dtype.
_COMPUTE_LEAVES = ("w", "b", "table", "wg", "wu", "wd", "dec_pos")
_FLOAT32_SUBTREES = ("router", "dt_proj", "gate_a", "gate_i")


def _leaf(name, a, cfg, device, training, parents):
    serve_cast = (name in _COMPUTE_LEAVES and not training
                  and not set(parents) & set(_FLOAT32_SUBTREES))
    dt = torch_dtype(cfg.dtype if serve_cast else cfg.param_dtype)
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device=device, dtype=dt)


def _convert(tree, cfg, device, training, index=None, parents=()):
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out[name] = _convert(sub, cfg, device, training, index, parents + (name,))
        else:
            a = np.asarray(sub)
            out[name] = _leaf(name, a if index is None else a[index], cfg, device, training,
                              parents)
    return out


def _n_stacked(tree) -> int:
    for sub in tree.values():
        return _n_stacked(sub) if isinstance(sub, dict) else int(np.asarray(sub).shape[0])
    raise ValueError("empty layer tree")


def _unstack(tree, n_want, cfg, device, training, what="layers"):
    n = _n_stacked(tree)
    if n != n_want:
        raise ValueError(f"tree has {n} stacked {what}, config {n_want}")
    return [_convert(tree, cfg, device, training, l) for l in range(n)]


def from_jax_params(cfg, tree, device="cuda", training: bool = False):
    """Port's parameter dict from the JAX ``init_lm``, ``init_encdec``,
    ``init_mamba_lm`` or ``init_rg`` tree
    (numpy leaves), in the training layout (every leaf in
    ``cfg.param_dtype``) or, by default, the serving one."""
    if "supers" in tree:
        n_super, n_tail = divmod(cfg.n_layers, len(cfg.block_pattern) or 3)
        params = {
            "embed": _convert(tree["embed"], cfg, device, training),
            "supers": _unstack(tree["supers"], n_super, cfg, device, training, "superblocks"),
            "final_norm": _convert(tree["final_norm"], cfg, device, training),
        }
        if "tail" in tree:
            params["tail"] = _unstack(tree["tail"], n_tail, cfg, device, training, "tail layers")
        if "lm_head" in tree:
            params["lm_head"] = _convert(tree["lm_head"], cfg, device, training)
        return params
    if "enc_layers" in tree:
        return {
            "embed": _convert(tree["embed"], cfg, device, training),
            "dec_pos": _leaf("dec_pos", tree["dec_pos"], cfg, device, training, ()),
            "enc_layers": _unstack(tree["enc_layers"], cfg.n_enc_layers, cfg, device, training,
                                   "encoder layers"),
            "dec_layers": _unstack(tree["dec_layers"], cfg.n_layers, cfg, device, training,
                                   "decoder layers"),
            "enc_norm": _convert(tree["enc_norm"], cfg, device, training),
            "dec_norm": _convert(tree["dec_norm"], cfg, device, training),
        }
    layers = _unstack(tree["layers"], cfg.n_layers, cfg, device, training)
    params = {
        "embed": _convert(tree["embed"], cfg, device, training),
        "layers": layers,
        "final_norm": _convert(tree["final_norm"], cfg, device, training),
    }
    if "lm_head" in tree:
        params["lm_head"] = _convert(tree["lm_head"], cfg, device, training)
    return params

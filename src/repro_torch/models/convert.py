"""Carry parameters of the JAX ``init_lm`` pytree across to the port.

The JAX tree stacks the layers on a leading L dim and stores dense weights
as ``(d_in, d_out)``, as the port does; tied embeddings need no ``lm_head``.
The input is the tree with numpy leaves (``jax.tree.map(np.asarray,
params)``), so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import torch_dtype

__all__ = ["from_jax_params"]

# Leaves stored in the compute dtype (cast once at load, see models.layers);
# every other leaf (norm scale/bias) keeps cfg.param_dtype.
_COMPUTE_LEAVES = ("w", "b", "table")


def _leaf(name, a, cfg, device):
    dt = torch_dtype(cfg.dtype if name in _COMPUTE_LEAVES else cfg.param_dtype)
    return torch.from_numpy(np.asarray(a, np.float32).copy()).to(device=device, dtype=dt)


def _convert(tree, cfg, device, index=None):
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out[name] = _convert(sub, cfg, device, index)
        else:
            a = np.asarray(sub)
            out[name] = _leaf(name, a if index is None else a[index], cfg, device)
    return out


def _n_stacked(tree) -> int:
    for sub in tree.values():
        return _n_stacked(sub) if isinstance(sub, dict) else int(np.asarray(sub).shape[0])
    raise ValueError("empty layer tree")


def from_jax_params(cfg, tree, device="cuda"):
    """Port's parameter dict from the JAX ``init_lm`` tree (numpy leaves)."""
    n = _n_stacked(tree["layers"])
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} stacked layers, config {cfg.n_layers}")
    params = {
        "embed": _convert(tree["embed"], cfg, device),
        "layers": [_convert(tree["layers"], cfg, device, l) for l in range(n)],
        "final_norm": _convert(tree["final_norm"], cfg, device),
    }
    if "lm_head" in tree:
        params["lm_head"] = _convert(tree["lm_head"], cfg, device)
    return params

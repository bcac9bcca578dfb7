"""Parameter and input sharding rules for the mesh (port of
``repro.sharding.rules``).

Weights use ZeRO-3-style 2D sharding purely for *storage*: a 2-D+ parameter
shards its penultimate dim over the data group (``("pod", "data")``
multi-pod, ``("data",)`` single-pod) and its last dim over ``model``; the
step gathers them before the forward pass and reduce-scatters their
gradients (``repro_torch.sharding``: the FSDP pattern; compute stays (data
x sequence)-parallel, memory is minimal).  Dims that don't divide evenly
fall back to fewer axes, then to replication: the rule is total, every
parameter gets a legal spec.

Expert weights ``(E, d, f)`` naturally shard E over ``model`` (expert
parallelism), because E is their first dim.

A spec is a tuple with one entry a dim: ``None``, an axis name, or a tuple
of axis names (indexed row-major, as JAX indexes them), the entries of the
reference's ``PartitionSpec``.  The port's layer trees are lists under
``layers``, ``supers``, ``tail``, ``enc_layers`` and ``dec_layers`` where
the JAX trees stack the layers on a leading dim (``models/convert.py``), so
the spec of a list entry is the reference's spec of the stacked leaf less
its leading ``None``.  A path is the tuple of dict keys and list indices
from the root to the leaf.
"""

from __future__ import annotations

__all__ = ["param_pspec", "params_shardings", "batch_shardings", "serve_state_shardings",
           "data_group", "map_with_path"]

_EXPERT_KEYS = ("wg", "wu", "wd")  # (E, d, f) expert stacks
_ROW_NAMES = {"wo", "down", "out", "out_proj", "lin_out"}


def data_group(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _axis_size(mesh, axes):
    n = 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        n *= mesh.shape[a]
    return n


def _divides(dim, mesh, axes):
    return axes is not None and dim % _axis_size(mesh, axes) == 0


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, x, path + (i,)) for i, x in enumerate(tree))
    return fn(path, tree)


def param_pspec(path, shape, mesh, mode: str = "train") -> tuple:
    """The spec of one parameter leaf.

    ``mode="train"``: ZeRO-3 2D storage sharding (weights gathered each
    step; right when activations dominate).
    ``mode="serve"``: Megatron-style, the last real dim over ``model``
    only, replicated over the data group: decode activations are tiny (one
    token), so resident TP-sharded weights beat gathers.
    """
    keys = [k for k in path if isinstance(k, str)]
    is_expert = bool(keys) and keys[-1] in _EXPERT_KEYS
    dims = list(shape)
    entries: list = [None] * len(dims)
    dg = data_group(mesh)
    dge = dg if len(dg) > 1 else dg[0]
    model = "model"
    real = list(range(len(dims)))

    if mode == "serve":
        if is_expert and len(real) == 3 and _divides(dims[real[0]], mesh, (model,)):
            entries[real[0]] = model  # expert-parallel stays on model
            return tuple(entries)
        # Megatron pairing: output projections (wo/down/...) are ROW-sharded
        # (contraction dim over model) so they compose with the col-sharded
        # qkv/gate/up without resharding the tiny decode activations.
        parent = keys[-2] if len(keys) >= 2 else None
        if parent in _ROW_NAMES or (keys and keys[-1] in _ROW_NAMES):
            prefer = real[:1] + real[-1:]
        else:
            prefer = (real[-1:] if real else []) + (real[-2:-1] if len(real) > 1 else [])
        for d in prefer:
            if _divides(dims[d], mesh, (model,)):
                entries[d] = model
                return tuple(entries)
        return tuple(entries)

    if is_expert and len(dims) == 3:
        # (E, d_in, d_out): experts over model (EP), d_in over the data group.
        if _divides(dims[0], mesh, (model,)):
            entries[0] = model
        if _divides(dims[1], mesh, dg):
            entries[1] = dge
        return tuple(entries)

    if len(real) >= 2:
        a, b = real[-2], real[-1]
        if _divides(dims[a], mesh, dg) and _divides(dims[b], mesh, (model,)):
            entries[a], entries[b] = dge, model
        elif _divides(dims[b], mesh, dg) and _divides(dims[a], mesh, (model,)):
            entries[a], entries[b] = model, dge
        elif _divides(dims[b], mesh, dg):
            entries[b] = dge
        elif _divides(dims[a], mesh, dg):
            entries[a] = dge
        elif _divides(dims[b], mesh, (model,)):
            entries[b] = model
    elif len(real) == 1:
        # 1-D (biases, norms): shard only if comfortably large.
        if dims[0] >= 4096 and _divides(dims[0], mesh, dg):
            entries[0] = dge
    return tuple(entries)


def params_shardings(params, mesh, mode: str = "train"):
    """Tree of specs matching a tree of tensors (or anything with ``shape``)."""
    return map_with_path(lambda path, x: param_pspec(path, tuple(x.shape), mesh, mode), params)


def batch_shardings(batch, mesh, pctx):
    """Specs of a train or prefill batch dict (tokens/labels/positions/...)."""
    dp = pctx.data_axis
    seq = pctx.seq_spec()

    def leaf(path, x):
        key = path[-1] if path else None
        nd = len(x.shape)
        if key == "frames":
            # encoder frames (B, S_enc, d): the encoder sequence shards too
            return (dp, seq, None)
        if key == "patch_embeds":
            return (dp, None, None)
        if nd == 2:
            return (dp, seq)
        if nd == 1:
            return (dp,)
        return (dp, *([None] * (nd - 1)))

    return map_with_path(leaf, batch)


def serve_state_shardings(state, mesh, pctx, cfg):
    """Specs of decode caches and states: the sequence dim of a cache and
    the width of a recurrent state over the SP axes (``"model"``, or
    ``("pod", "model")`` on the pod mesh, where the port orders a recurrent
    state's slices model-major: ``models.layers.state_tp``)."""
    dp = pctx.data_axis
    seq = pctx.seq_spec()

    def leaf(path, x):
        keys = [k for k in path if isinstance(k, str)]
        nd = len(x.shape)
        name = keys[-1] if keys else None
        if name in ("k", "v", "xk", "xv"):
            # (L, B, S, Hkv, D): seq over SP axes, batch over data.
            return (None, dp, seq, None, None)
        if name in ("pos", "enc_pos"):
            return (dp, seq)
        if name == "len":
            return (dp,)
        if name == "ssm":  # (L, B, di, N): d_inner over the SP axes
            return (None, dp, seq, None)
        if name == "conv":  # (L, B, K-1, di)
            return (None, dp, None, seq)
        if name == "rec_h":  # (n_super, 2, B, lru)
            return (None, None, dp, seq)
        if name == "rec_conv":  # (n_super, 2, B, K-1, lru)
            return (None, None, dp, None, seq)
        if name == "tail_h":
            return (None, dp, seq)
        if name == "tail_conv":
            return (None, dp, None, seq)
        return (None,) * nd

    return map_with_path(leaf, state)

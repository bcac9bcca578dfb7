"""FSDP storage over a mesh: the sharding rules (``sharding/rules.py``) and
the mechanism XLA's SPMD gives the reference, written as PyTorch code.

**Blocks.**  A leaf of spec ``s`` on a mesh is cut into ``G`` blocks, ``G``
the product of the sizes of the axes ``s`` names; the rank at coordinates
``c`` holds the block whose index is row-major over those axes (in mesh
order) at ``c``, and every rank that differs from it only on axes ``s``
leaves out holds the same block.  A dim whose entry is a tuple of axes
(``("pod", "data")``) is indexed row-major over the tuple, as JAX does.
A sharded leaf is a tensor of blocks, ``(k, *block)``: ``k = G`` on the
virtual mesh (one process holds every distinct block once), ``k = 1`` on a
process group (this rank's block).  A leaf whose spec is ``None`` (a
scalar, the step counters) is stored whole.

**The step.**  :func:`gather_params` is one ``torch.autograd.Function``
over the whole parameter tree: its forward all-gathers each leaf over the
axes its spec names and assembles the full tensor (a fresh buffer, never a
view of the blocks the optimizer updates in place); its backward cuts each
full gradient into blocks, reduce-scatters them (sum) over the same axes
and all-reduces the block (sum) over the axes the spec leaves out, so every
rank ends with its block of the gradient summed over every rank.  The
trainer gathers once a step, outside the remat regions, so a remat of
``"full"`` does not gather twice (the reference gathers per layer inside
its scan).  On the virtual mesh the one full gradient already sums every
rank's (the batch holds every data rank's rows), so the collectives only
count their bytes and cut; on a process group they run over the mesh's
subgroups.  :func:`fsdp_comm_bytes` is the closed form of one step's bytes
a rank and direction, which the ledger's ``"data"`` class must equal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.sharding.rules import (
    batch_shardings,
    data_group,
    map_with_path,
    param_pspec,
    params_shardings,
    serve_state_shardings,
)

__all__ = ["batch_shardings", "data_group", "param_pspec", "params_shardings",
           "serve_state_shardings", "Layout", "layout_for", "spec_axes", "block_index",
           "cut_blocks", "assemble_blocks", "shard_state", "shard_tree", "unshard_tree",
           "gather_params", "fsdp_comm_bytes", "state_bytes", "batch_block", "spec_leaves"]


def _entry_axes(e) -> tuple[str, ...]:
    return e if isinstance(e, tuple) else (() if e is None else (e,))


def spec_axes(spec, mesh) -> tuple[str, ...]:
    """The axes ``spec`` names, in mesh order."""
    named = {a for e in spec or () for a in _entry_axes(e)}
    return tuple(a for a in mesh.axis_names if a in named)


def block_index(spec, mesh, rank: int) -> int:
    """Index of ``rank``'s block among the ``G`` blocks of ``spec``."""
    c = mesh.coords(rank)
    idx = 0
    for a in spec_axes(spec, mesh):
        idx = idx * mesh.shape[a] + c[a]
    return idx


def _permute(x, order):
    return x.permute(order) if isinstance(x, torch.Tensor) else x.transpose(order)


def cut_blocks(full, spec, mesh):
    """``full`` (a tensor or a numpy array) -> its ``(G, *block)`` blocks."""
    axes = spec_axes(spec, mesh)
    sizes = [mesh.shape[a] for a in axes]
    split, where = [], {}
    for i, e in enumerate(spec):
        ents = _entry_axes(e)
        n = math.prod(mesh.shape[a] for a in ents)
        if full.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(full.shape)} does not divide over {ents}")
        for a in ents:
            where[a] = len(split)
            split.append(mesh.shape[a])
        where[i] = len(split)
        split.append(full.shape[i] // n)
    x = full.reshape(split)
    order = [where[a] for a in axes] + [where[i] for i in range(len(spec))]
    block = [full.shape[i] // math.prod(mesh.shape[a] for a in _entry_axes(e))
             for i, e in enumerate(spec)]
    return _permute(x, order).reshape([math.prod(sizes), *block])


def assemble_blocks(blocks, spec, mesh):
    """Inverse of :func:`cut_blocks`: ``(G, *block)`` -> the full array
    (a new contiguous tensor for a tensor input)."""
    axes = spec_axes(spec, mesh)
    block = list(blocks.shape[1:])
    x = blocks.reshape([mesh.shape[a] for a in axes] + block)
    order, shape = [], []
    for i, e in enumerate(spec):
        ents = _entry_axes(e)
        order += [axes.index(a) for a in ents] + [len(axes) + i]
        shape.append(block[i] * math.prod(mesh.shape[a] for a in ents))
    out = _permute(x, order).reshape(shape)
    if isinstance(out, torch.Tensor):
        fresh = torch.empty(out.shape, dtype=out.dtype, device=out.device)
        return fresh.copy_(out)
    return out


@dataclass(frozen=True)
class Layout:
    """How a tree is stored over ``mesh``: ``specs`` a tree of specs (``None``
    for a leaf stored whole), ``meta`` the full shapes and dtypes (meta
    tensors), ``rank`` this process's rank (``None``: every block, the
    virtual mesh)."""

    mesh: Any
    specs: Any
    meta: Any
    rank: int | None = None

    def with_mesh(self, mesh, rank: int | None = None) -> "Layout":
        """The same tree laid out by the rules on another mesh."""
        return layout_for(self.meta, mesh, rank=rank)


def layout_for(tree, mesh, rank: int | None = None, mode: str = "train") -> Layout:
    """The rules' layout of ``tree`` (full tensors, or meta tensors): every
    floating leaf with a dim gets :func:`param_pspec` of its path (the
    AdamW moments mirror the parameters), the rest is stored whole."""
    def spec(path, x):
        if x.ndim == 0 or not x.is_floating_point():
            return None
        return param_pspec(path, tuple(x.shape), mesh, mode)

    meta = map_with_path(lambda _, x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)
    return Layout(mesh, map_with_path(spec, tree), meta, rank)


def spec_leaves(specs):
    """Specs in tree order (a spec is a tuple or ``None``, so a leaf here)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for sub in specs for x in spec_leaves(sub)]
    return [specs]


def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` in tree order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _cut_leaf(x, spec, mesh, rank):
    if spec is None:
        return x.detach().clone()
    blocks = cut_blocks(x.detach(), spec, mesh)
    if rank is not None:
        i = block_index(spec, mesh, rank)
        blocks = blocks[i:i + 1]
    return blocks.contiguous().clone()


def shard_tree(tree, layout: Layout):
    """Each leaf of ``tree`` (full tensors) cut to ``layout.rank``'s block
    of its spec (every block with ``rank=None``), as new tensors."""
    specs = spec_leaves(layout.specs)
    leaves = tree_leaves(tree)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    return _rebuild(tree, [_cut_leaf(x, s, layout.mesh, layout.rank)
                           for x, s in zip(leaves, specs)])


def shard_state(tree, mesh, rank: int | None = None):
    """``(shards, layout)``: ``tree`` cut by the rules on ``mesh`` to
    ``rank``'s blocks (``None``: every block, the virtual mesh)."""
    layout = layout_for(tree, mesh, rank)
    return shard_tree(tree, layout), layout


def unshard_tree(tree, layout: Layout, comm=None):
    """The full tensors of a sharded tree: assembled from the blocks on the
    virtual mesh; all-gathered over ``comm`` (a process group's mesh
    transport, collective) otherwise.  Not differentiable, not counted."""
    def leaf(x, spec):
        if spec is None:
            return x.detach().clone()
        blocks = x.detach()
        if layout.rank is not None:
            blocks = comm.gather(blocks, spec_axes(spec, layout.mesh), count=False)
        return assemble_blocks(blocks, spec, layout.mesh)

    return _rebuild(tree, [leaf(x, s) for x, s in zip(tree_leaves(tree),
                                                      spec_leaves(layout.specs))])


class _GatherParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, mesh, specs, *blocks):
        ctx.comm, ctx.mesh, ctx.specs = comm, mesh, specs
        out = []
        for b, s in zip(blocks, specs):
            if s is None:
                out.append(b.clone())
                continue
            out.append(assemble_blocks(comm.gather(b, spec_axes(s, mesh)), s, mesh))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        comm, mesh = ctx.comm, ctx.mesh
        out = []
        for g, s in zip(grads, ctx.specs):
            if s is None:
                out.append(g)
                continue
            axes = spec_axes(s, mesh)
            rest = tuple(a for a in mesh.axis_names if a not in axes)
            b = comm.reduce_scatter(cut_blocks(g, s, mesh).contiguous(), axes)
            out.append(comm.all_reduce(b, rest))
        return (None, None, None, *out)


def gather_params(shards, layout: Layout, comm):
    """The full parameter tree from its blocks (module docstring), one
    differentiable gather over every leaf: every rank runs every leaf's
    collectives in tree order, forward and backward (an unused output's
    gradient is a zero tensor, so the backward's reduce-scatters still run
    on every rank)."""
    full = _GatherParams.apply(comm, layout.mesh, spec_leaves(layout.specs),
                               *tree_leaves(shards))
    return _rebuild(shards, full)


def fsdp_comm_bytes(layout: Layout) -> dict[str, float]:
    """One step's FSDP bytes a rank and direction (the transports'
    conventions, ``core/collectives.py``): each leaf of ``n`` bytes with
    ``G`` blocks all-gathers its blocks (``(G-1)/G * n / 2`` a direction),
    reduce-scatters its gradient (the same) and all-reduces the gradient's
    block over the ``A = ranks / G`` ranks that hold it (``(A-1)/A * n / G``);
    the gradient has the parameter's dtype."""
    total = 0.0
    mesh = layout.mesh
    for x, s in zip(tree_leaves(layout.meta), spec_leaves(layout.specs)):
        if s is None:
            continue
        n = x.numel() * x.element_size()
        G = math.prod(mesh.shape[a] for a in spec_axes(s, mesh))
        A = mesh.size // G
        total += (G - 1) / G * n + (A - 1) / A * n / G
    return {"fwd": total, "bwd": total}


def state_bytes(layout: Layout, rank: int = 0) -> int:
    """Bytes of ``rank``'s blocks of every leaf of ``layout`` (a leaf stored
    whole counts whole): what one process of a real mesh holds."""
    mesh = layout.mesh
    total = 0
    for x, s in zip(tree_leaves(layout.meta), spec_leaves(layout.specs)):
        n = x.numel() * x.element_size()
        total += n if s is None else n // math.prod(mesh.shape[a] for a in spec_axes(s, mesh))
    return total


def batch_block(batch, pctx, rank: int):
    """``rank``'s (data, sequence) block of a batch dict (numpy arrays or
    tensors) by :func:`batch_shardings` on ``pctx.mesh``."""
    mesh = pctx.mesh
    specs = batch_shardings(batch, mesh, pctx)

    def leaf(x, spec):
        spec = tuple(spec)[:x.ndim]
        spec = spec + (None,) * (x.ndim - len(spec))
        return cut_blocks(x, spec, mesh)[block_index(spec, mesh, rank)]

    return tree_map(leaf, batch, specs)

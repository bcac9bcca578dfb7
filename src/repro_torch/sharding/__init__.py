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

**The step.**  The gather is one ``torch.autograd.Function`` over a
subtree: its forward all-gathers each leaf over the axes its spec names
and assembles the full tensor (a fresh buffer, never a view of the blocks
the optimizer updates in place); its backward cuts each full gradient into
blocks, reduce-scatters them (sum) over the same axes and all-reduces the
block (sum) over the axes the spec leaves out, so every rank ends with its
block of the gradient summed over every rank.  A step gathers as the
reference's XLA does, just in time (:func:`gather_step_params`): the
leaves outside the layer stacks (embedding, head, final norm) once, at the
start of the loss; each entry of a layer stack (``STACKED``: the entries
of ``layers``, ``supers``, ``tail``, ``enc_layers`` and ``dec_layers``,
the reference's scanned leaves) reaches its layer loop as a
:class:`LayerBlocks`, which the loop gathers (:func:`layer_params`) as the
first step inside the layer's remat region.  Under remat a rank holds
one layer's full copy at a time and gathers each layer again when the
backward recomputes it, as the reference's scan under ``jax.checkpoint``
does (``"dots"`` saves the weight products' outputs, not the gather);
with remat ``"none"`` the autograd graph keeps every layer's gathered
weights for the backward, as the scan keeps its residuals.
:func:`gather_params` gathers a whole tree at once.  On the virtual mesh
the one full gradient already sums every rank's (the batch holds every
data rank's rows), so the collectives only count their bytes and cut; on a
process group they run over the mesh's subgroups.
:func:`fsdp_comm_bytes` is the closed form of one step's bytes a rank and
direction, which the ledger's ``"data"`` class must equal;
:func:`fsdp_gathered_bytes` the most gathered bytes alive at once, which
the ledger's high-water must equal under remat.

**Serve storage** (``mode="serve"``, the reference's Megatron layout for
decode): ``shard_tree`` of a serve layout turns each leaf that the rule
splits over ``model`` into a :class:`ServeBlocks`, its blocks resident for
good (the same ``(k, *block)`` tensor, ``k`` the model size on the virtual
mesh, 1 on a process group), and keeps every other leaf whole.  The decode
step of every family binds them, once, to the context's mesh transport
(:func:`bind_serve`) and the layers compute on the blocks with the
tensor-parallel collectives their split implies (``models/layers.py``);
nothing is gathered into a full weight but the 1-D leaves that need the
whole vector (norm scales) and a leaf the rule splits on a dim that the
decode state does not split (falcon-mamba's ``A_log``).  On the pod mesh
the blocks are replicated over ``pod`` as over ``data``; a recurrent state
split over ``("pod", "model")`` is finer than them, and each rank takes its
part of its own block (``models.layers.state_tp``), so no weight moves.
:func:`serve_split` is the dim a serve spec splits; the closed form of a
decode step's bytes on such blocks sits beside the step it describes
(``serve_comm_bytes`` in ``models.transformer``,
``encdec_serve_comm_bytes``, ``mamba_serve_comm_bytes``,
``rg_serve_comm_bytes``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
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
           "gather_params", "fsdp_comm_bytes", "state_bytes", "batch_block", "spec_leaves",
           "STACKED", "LayerBlocks", "layer_params", "gather_step_params", "fsdp_gathered_bytes",
           "tree_bytes", "ServeBlocks", "bind_serve", "serve_split"]

# The layer stacks: the reference's scanned leaves (``sharding/rules.py``'s
# ``_STACKED``), each a list of per-layer entries here.
STACKED = ("layers", "supers", "tail", "enc_layers", "dec_layers")


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
    mode: str = "train"  # the rules' mode: "train" (FSDP) or "serve" (Megatron)

    def with_mesh(self, mesh, rank: int | None = None) -> "Layout":
        """The same tree laid out by the rules, in the same mode, on
        another mesh."""
        return layout_for(self.meta, mesh, rank=rank, mode=self.mode)


def layout_for(tree, mesh, rank: int | None = None, mode: str = "train") -> Layout:
    """The rules' layout of ``tree`` (full tensors, or meta tensors): every
    floating leaf with a dim gets :func:`param_pspec` of its path (the
    AdamW moments mirror the parameters), the rest is stored whole."""
    def spec(path, x):
        if x.ndim == 0 or not x.is_floating_point():
            return None
        return param_pspec(path, tuple(x.shape), mesh, mode)

    meta = map_with_path(lambda _, x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree)
    return Layout(mesh, map_with_path(spec, tree), meta, rank, mode)


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


def _groups(spec, mesh) -> int:
    return math.prod(mesh.shape[a] for a in spec_axes(spec, mesh))


def _cut_leaf(x, spec, mesh, rank, mode="train"):
    if spec is None or (mode == "serve" and _groups(spec, mesh) == 1):
        return x.detach().clone()
    blocks = cut_blocks(x.detach(), spec, mesh)
    if rank is not None:
        i = block_index(spec, mesh, rank)
        blocks = blocks[i:i + 1]
    blocks = blocks.contiguous().clone()
    return ServeBlocks(blocks, spec, mesh) if mode == "serve" else blocks


def shard_tree(tree, layout: Layout):
    """Each leaf of ``tree`` (full tensors) cut to ``layout.rank``'s block
    of its spec (every block with ``rank=None``), as new tensors; a serve
    layout's split leaves as :class:`ServeBlocks`."""
    specs = spec_leaves(layout.specs)
    leaves = tree_leaves(tree)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves against {len(specs)} specs")
    return _rebuild(tree, [_cut_leaf(x, s, layout.mesh, layout.rank, layout.mode)
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
        if isinstance(x, ServeBlocks):
            x = x.blocks
        elif spec is None or layout.mode == "serve":
            return x.detach().clone()
        blocks = x.detach()
        if layout.rank is not None:
            blocks = comm.gather(blocks, spec_axes(spec, layout.mesh), count=False)
        return assemble_blocks(blocks, spec, layout.mesh)

    return _rebuild(tree, [leaf(x, s) for x, s in zip(tree_leaves(tree),
                                                      spec_leaves(layout.specs))])


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, mesh, specs, *blocks):
        ctx.comm, ctx.mesh, ctx.specs = comm, mesh, specs
        out = []
        for b, s in zip(blocks, specs):
            full = (b.clone() if s is None else
                    assemble_blocks(comm.gather(b, spec_axes(s, mesh)), s, mesh))
            comm.ledger.hold(full)
            out.append(full)
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
    """The full tree from its blocks (module docstring), one differentiable
    gather over every leaf: every rank runs every leaf's collectives in
    tree order, forward and backward (an unused output's gradient is a zero
    tensor, so the backward's reduce-scatters still run on every rank)."""
    full = _Gather.apply(comm, layout.mesh, spec_leaves(layout.specs), *tree_leaves(shards))
    return _rebuild(shards, full)


@dataclass(frozen=True, eq=False)
class LayerBlocks:
    """One entry of a layer stack as its blocks (``blocks``, a subtree of
    tensors of blocks, laid out by ``layout``), for the layer loop to gather
    inside its remat region (:func:`layer_params`)."""

    blocks: Any
    layout: Layout
    comm: Any

    def gather(self):
        return gather_params(self.blocks, self.layout, self.comm)


def layer_params(p):
    """A layer loop's entry as full tensors: gathered now if it is a
    :class:`LayerBlocks`, else ``p`` itself (no mesh)."""
    return p.gather() if isinstance(p, LayerBlocks) else p


def gather_step_params(shards, layout: Layout, comm):
    """The parameter tree a step's loss takes (module docstring): the leaves
    outside ``STACKED`` gathered by one :func:`gather_params`, each entry
    of a layer stack a :class:`LayerBlocks`."""
    def sub(specs, meta):
        return Layout(layout.mesh, specs, meta, layout.rank)

    rest = [k for k in shards if k not in STACKED]
    full = gather_params({k: shards[k] for k in rest},
                         sub({k: layout.specs[k] for k in rest},
                             {k: layout.meta[k] for k in rest}), comm)
    for k in STACKED:
        if k in shards:
            full[k] = [LayerBlocks(b, sub(s, m), comm)
                       for b, s, m in zip(shards[k], layout.specs[k], layout.meta[k])]
    return full


@dataclass(eq=False)
class ServeBlocks:
    """A leaf of serve storage (module docstring): ``blocks`` ``(k,
    *block)``, the resident blocks this process holds of a weight whose
    serve spec ``spec`` splits one dim over ``model`` (all ``k`` = model
    size of them on the virtual mesh, this rank's on a process group);
    ``comm`` the mesh transport whose tensor-parallel collectives the
    layers run on, bound once by :func:`bind_serve`."""

    blocks: torch.Tensor
    spec: tuple
    mesh: Any
    comm: Any = None

    @property
    def split(self) -> int:
        """The dim that the spec splits."""
        return serve_split(self.spec, self.mesh)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(n * math.prod(self.mesh.shape[a] for a in _entry_axes(e))
                     for n, e in zip(self.blocks.shape[1:], self.spec))

    @property
    def T(self) -> "ServeBlocks":
        """The transpose of a 2-D leaf (a tied head's ``table.T``)."""
        return replace(self, blocks=self.blocks.transpose(1, 2), spec=self.spec[::-1])

    def transport(self):
        if self.comm is None:
            raise RuntimeError("serve blocks reach a layer unbound: the decode steps "
                               "(lm_decode_step, encdec_decode_step, mamba_decode_step, "
                               "rg_decode_step) bind them to their context's mesh transport, "
                               "and no other step takes serve storage")
        return self.comm

    def whole(self):
        """The full tensor, its blocks all-gathered over the spec's axes
        (the ledger's ``"tp"`` class): a 1-D leaf that the layer needs
        whole (a norm scale)."""
        blocks = self.transport().gather(self.blocks, spec_axes(self.spec, self.mesh),
                                         link_class="tp")
        return assemble_blocks(blocks, self.spec, self.mesh)


def bind_serve(tree, comm):
    """Bind every :class:`ServeBlocks` leaf of ``tree`` to ``comm`` (the
    context's mesh transport, ``pctx.storage``) in place, the first time;
    a leaf bound to ``comm`` already stays as it is, one bound to another
    transport is refused (``shard_tree`` cuts a tree for each context)."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, list):
        tree = [tree]
    for leaf in tree:
        if isinstance(leaf, (dict, list)):
            bind_serve(leaf, comm)
        elif isinstance(leaf, ServeBlocks) and leaf.comm is not comm:
            if comm is None or comm.mesh != leaf.mesh:
                raise ValueError(f"serve blocks of the mesh {leaf.mesh.shape} need a context "
                                 "over it (launch.mesh.make_pctx(mesh))")
            if leaf.comm is not None:
                raise ValueError("serve blocks bound to another context's transport: cut the "
                                 "tree again (shard_tree) for this one")
            leaf.comm = comm


def _leaf_bytes(x) -> int:
    if isinstance(x, ServeBlocks):
        x = x.blocks
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a tree (meta or not; serve blocks by their
    blocks; other leaves none), in full."""
    return sum(_leaf_bytes(x) for x in tree_leaves(tree))


def fsdp_comm_bytes(layout: Layout, remat: str = "none",
                    microbatches: int = 1) -> dict[str, float]:
    """One step's FSDP bytes a rank and direction (the transports'
    conventions, ``core/collectives.py``) under the step of
    :func:`gather_step_params`: each leaf of ``n`` bytes with ``G`` blocks
    all-gathers its blocks (``(G-1)/G * n / 2`` a direction), reduce-scatters
    its gradient (the same) and all-reduces the gradient's block over the
    ``A = ranks / G`` ranks that hold it (``(A-1)/A * n / G``), once a
    microbatch; a leaf of a layer stack all-gathers again when a remat other
    than ``"none"`` recomputes its layer.  The gradient has the parameter's
    dtype."""
    total = 0.0
    mesh = layout.mesh
    for key in sorted(layout.specs):
        gathers = 1 + (remat != "none") if key in STACKED else 1
        for x, s in zip(tree_leaves(layout.meta[key]), spec_leaves(layout.specs[key])):
            if s is None:
                continue
            n = _leaf_bytes(x)
            G = math.prod(mesh.shape[a] for a in spec_axes(s, mesh))
            A = mesh.size // G
            total += (gathers + 1) * (G - 1) / G * n / 2 + (A - 1) / A * n / G
    total *= microbatches
    return {"fwd": total, "bwd": total}


def fsdp_gathered_bytes(layout: Layout) -> int:
    """The most gathered bytes alive at once under :func:`gather_step_params`
    with remat: the leaves outside the layer stacks and the largest entry of
    a stack, in full.  What one rank of a real mesh holds beyond its blocks
    (:func:`tree_bytes` of ``layout.meta``: the whole-tree gather's)."""
    rest = sum(tree_bytes(layout.meta[k]) for k in layout.meta if k not in STACKED)
    entries = [tree_bytes(e) for k in STACKED for e in layout.meta.get(k, ())]
    return rest + max(entries, default=0)


def serve_split(spec, mesh):
    """The dim a serve spec splits over more than one rank, else ``None``."""
    if spec is None or _groups(spec, mesh) == 1:
        return None
    return next(i for i, e in enumerate(spec) if _entry_axes(e))


def state_bytes(layout: Layout, rank: int = 0) -> int:
    """Bytes of ``rank``'s blocks of every leaf of ``layout`` (a leaf stored
    whole counts whole): what one process of a real mesh holds."""
    mesh = layout.mesh
    total = 0
    for x, s in zip(tree_leaves(layout.meta), spec_leaves(layout.specs)):
        n = _leaf_bytes(x)
        total += n if s is None else n // math.prod(mesh.shape[a] for a in spec_axes(s, mesh))
    return total


def batch_block(batch, pctx, rank: int):
    """``rank``'s (data, sequence) block of a batch dict (numpy arrays or
    tensors) by :func:`batch_shardings` on ``pctx.mesh``; a VLM's text
    (tokens, labels, mask) stays whole over the sequence axes, as its image
    does: the sequence (image, then text) is cut as the positions are, and
    each rank embeds its own shard of it (``models.transformer._embed_rows``)."""
    mesh = pctx.mesh
    specs = batch_shardings(batch, mesh, pctx)
    if "patch_embeds" in batch:
        specs = {k: (v[0], None) if k in ("tokens", "labels", "mask") else v
                 for k, v in specs.items()}

    def leaf(x, spec):
        spec = tuple(spec)[:x.ndim]
        spec = spec + (None,) * (x.ndim - len(spec))
        return cut_blocks(x, spec, mesh)[block_index(spec, mesh, rank)]

    return tree_map(leaf, batch, specs)

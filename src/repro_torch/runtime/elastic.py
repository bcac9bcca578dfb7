"""Elastic re-meshing: continue a job on a different set of ranks (port of
``repro.runtime.elastic``).

When hosts die (or capacity arrives), the surviving ranks form a new mesh
and the training state is re-laid-out onto it.  Because checkpoints restore
onto a *target* layout (``checkpoint/manager.py``), elasticity reduces to:

    new_mesh = shrink_mesh(n_survivors, model_axis=P)
    state, layout = reshard(state, layout, new_mesh)   # gather -> re-cut

:func:`shrink_mesh` picks the largest ``(data', model')`` grid that fits the
surviving rank count while keeping the model axis intact if possible (the
SP ring must keep dividing the sequence length).  On a process group the
old ranks' blocks must still be readable (every old rank takes part in the
gather), as the reference's ``device_get`` assumes; a lost rank's blocks
come back through the checkpoint.
"""

from __future__ import annotations

from repro_torch.launch.mesh import Mesh

__all__ = ["shrink_mesh", "reshard", "ElasticState"]


def shrink_mesh(ranks, *, model_axis: int, axis_names=("data", "model")) -> Mesh:
    """The largest mesh over ``ranks`` (a count, or a sequence of ranks)
    with a fixed model-axis size: the model axis halves while it does not
    divide, or exceeds, the rank count."""
    n = ranks if isinstance(ranks, int) else len(ranks)
    model = model_axis
    while model > 1 and (n % model or model > n):
        model //= 2
    return Mesh(tuple(axis_names), (n // model, model))


def reshard(state, layout, new_mesh: Mesh, *, rank: int | None = None, comm=None):
    """``(state, layout)`` re-laid-out onto ``new_mesh`` by the same rules:
    every leaf gathered (assembled on the virtual mesh; all-gathered over
    ``comm``, the old mesh's transport, on a process group) and cut to
    ``rank``'s blocks of the new layout (``None``: every block)."""
    from repro_torch.sharding import shard_tree, unshard_tree

    full = unshard_tree(state, layout, comm)
    new = layout.with_mesh(new_mesh, rank)
    return shard_tree(full, new), new


class ElasticState:
    """Tracks the active mesh; re-lays the state out when the rank set
    changes."""

    def __init__(self, layout, comm=None):
        self.layout, self.comm = layout, comm

    @property
    def mesh(self) -> Mesh:
        return self.layout.mesh

    def migrate(self, state, ranks, *, model_axis: int, rank: int | None = None):
        """``(state, mesh)`` on the mesh :func:`shrink_mesh` gives ``ranks``."""
        mesh = shrink_mesh(ranks, model_axis=model_axis)
        state, self.layout = reshard(state, self.layout, mesh, rank=rank, comm=self.comm)
        return state, mesh

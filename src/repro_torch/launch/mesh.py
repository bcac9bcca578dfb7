"""Mesh descriptions (port of ``repro.launch.mesh``).

Single pod: ``(data=16, model=16)`` = 256 ranks.  Multi-pod: ``(pod=2,
data=16, model=16)`` = 512 ranks.  ``model`` is the sequence-parallel ring
(TokenRing's axis), ``pod`` the inter-pod KV ring of the paper's Case Study
III, ``data`` is data parallelism with FSDP storage.

A :class:`Mesh` holds names and sizes only, no devices: the reference's
``jax.sharding.Mesh`` places devices, the port places ranks.  Rank order is
row-major over the axes, the JAX mesh's device order: rank ``d * P + m``
on ``(data, model)``.  One process runs every rank of a mesh on the
virtual mesh (``core.api.ParallelContext`` without ``ring=``); a
``torch.distributed`` group of ``mesh.size`` processes runs one each.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["Mesh", "data_mesh", "make_production_mesh", "make_pctx", "SINGLE_POD_SHAPE",
           "MULTI_POD_SHAPE"]

SINGLE_POD_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``shape`` maps name to size, as
    ``jax.sharding.Mesh.shape`` does."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "axis_sizes", tuple(int(n) for n in self.axis_sizes))
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.axis_sizes} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(n < 1 for n in self.axis_sizes):
            raise ValueError(f"axis sizes must be >= 1, got {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, rank: int) -> dict[str, int]:
        """The coordinates of ``rank``, row-major."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} not in a mesh of {self.size}")
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.axis_sizes)):
            rank, out[name] = divmod(rank, n)
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        rank = 0
        for name, n in zip(self.axis_names, self.axis_sizes):
            rank = rank * n + coords.get(name, 0)
        return rank

    def group(self, axes, rank: int) -> list[int]:
        """The ranks that share ``rank``'s coordinates on every axis not in
        ``axes``, in row-major order over ``axes`` (ascending rank)."""
        base = self.coords(rank)
        free = [a for a in self.axis_names if a in axes]
        out = []
        for i in range(math.prod(self.shape[a] for a in free)):
            c = dict(base)
            for a in reversed(free):
                i, c[a] = divmod(i, self.shape[a])
            out.append(self.rank_of(c))
        return out


def data_mesh(data: int, model: int, pods: int = 1) -> Mesh:
    """``(data, model)``, or ``(pod, data, model)`` with ``pods > 1``."""
    if pods > 1:
        return Mesh(("pod", "data", "model"), (pods, data, model))
    return Mesh(("data", "model"), (data, model))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), MULTI_POD_SHAPE)
    return Mesh(("data", "model"), SINGLE_POD_SHAPE)


def make_pctx(mesh: Mesh, *, strategy: str = "tokenring", layout: str = "zigzag",
              impl: str = "auto", global_batch: int | None = None, block_q: int = 512,
              block_k: int = 512, inner_strategy: str | None = None, device: str = "cuda",
              ring=None):
    """The ``ParallelContext`` of ``mesh``; drops the data axis (a data
    degree of 1: the batch replicated over ``data``, the weights still
    stored over it) when the global batch does not divide over it, as the
    reference does (e.g. long_500k's global_batch=1).  ``ring``: a
    ``torch.distributed`` group of ``mesh.size`` ranks (``None``: the
    virtual mesh in this process)."""
    from repro_torch.core.api import ParallelContext

    shape = mesh.shape
    pods = shape.get("pod", 1)
    data = shape["data"]
    if global_batch is not None and global_batch % data:
        data = 1
    return ParallelContext(mesh=mesh, data_degree=data, sp_degree=pods * shape["model"],
                           pods=pods, strategy=strategy, layout=layout, impl=impl,
                           block_q=block_q, block_k=block_k, inner_strategy=inner_strategy,
                           device=device, ring=ring)

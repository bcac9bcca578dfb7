"""Zigzag causal load balancing (copy of ``repro.core.zigzag``, paper §3.3.2).

Under causal attention, sharding the sequence into ``P`` contiguous chunks
gives rank 0 almost no work and rank ``P-1`` the full quadratic cost.  The
zigzag layout splits the sequence into ``2P`` chunks and gives rank ``j`` the
pair ``(j, 2P-1-j)``, an early chunk and a late one, so every rank owns the
same causal workload.

The layout is global position bookkeeping: every sharded tensor keeps its
natural order within each rank, and masks always come from the global token
positions (``zigzag_positions``), so every strategy is correct under any
layout and the kernels skip fully-masked tiles by comparing position ranges.

Terminology: ``P`` sequence shards; ``S`` global sequence length, chunk
size ``C = S / (2P)``; "contig" is the plain contiguous layout.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.preconditions import check_zigzag_divisible, require

__all__ = [
    "check_zigzag_divisible",
    "zigzag_chunk_ids",
    "zigzag_device_order",
    "to_zigzag",
    "from_zigzag",
    "zigzag_positions",
    "contig_positions",
    "block_kind",
    "BLOCK_EMPTY",
    "BLOCK_DIAG",
    "BLOCK_FULL",
]

# Block mask kinds between a query chunk and a key chunk (global chunk ids):
BLOCK_EMPTY = 0  # q chunk strictly before k chunk: fully masked, skippable
BLOCK_DIAG = 1  # same chunk: lower-triangular mask
BLOCK_FULL = 2  # q chunk strictly after k chunk: no mask


def _require_divisible(S: int, P: int):
    require(check_zigzag_divisible(S, P))


def zigzag_chunk_ids(P: int):
    """Global chunk ids ``(early, late)`` owned by each rank ``j``."""
    return [(j, 2 * P - 1 - j) for j in range(P)]


def zigzag_device_order(P: int) -> np.ndarray:
    """Entry ``i`` is the global chunk id stored at zigzag slot ``i`` (slots
    are rank-major: rank j holds slots ``2j`` and ``2j+1``)."""
    order = []
    for j in range(P):
        order += [j, 2 * P - 1 - j]
    return np.asarray(order)


def to_zigzag(x, P: int, axis: int = 1):
    """Reorder a global sequence tensor from contiguous to zigzag layout."""
    _require_divisible(x.shape[axis], P)
    xs = torch.chunk(x, 2 * P, dim=axis)
    return torch.cat([xs[int(c)] for c in zigzag_device_order(P)], dim=axis)


def from_zigzag(x, P: int, axis: int = 1):
    """Inverse of :func:`to_zigzag`."""
    _require_divisible(x.shape[axis], P)
    order = zigzag_device_order(P)
    inv = np.empty_like(order)
    inv[order] = np.arange(2 * P)
    xs = torch.chunk(x, 2 * P, dim=axis)
    return torch.cat([xs[int(c)] for c in inv], dim=axis)


def zigzag_positions(S: int, P: int, j: int, device=None):
    """Global token positions held by rank ``j`` in zigzag layout, ``(S/P,)`` int32."""
    _require_divisible(S, P)
    C = S // (2 * P)
    base = torch.arange(C, dtype=torch.int32, device=device)
    return torch.cat([j * C + base, (2 * P - 1 - j) * C + base])


def contig_positions(S: int, P: int, j: int, device=None):
    """Global token positions for the contiguous layout."""
    L = S // P
    return j * L + torch.arange(L, dtype=torch.int32, device=device)


def block_kind(q_chunk: int, k_chunk: int) -> int:
    """Mask kind between two global chunk ids under causal attention."""
    if q_chunk > k_chunk:
        return BLOCK_FULL
    if q_chunk == k_chunk:
        return BLOCK_DIAG
    return BLOCK_EMPTY

"""Paged KV cache: page allocator, pool state and page-table arithmetic
(port of ``repro.serving.kv_cache``; the prefix index waits for a later slice).

KV lives in fixed-size pages drawn from one shared pool; each slot holds a
block table mapping its logical token positions to pages.  An unmapped
block-table entry holds ``n_pages`` (one past the last page).

Torch has neither JAX's ``mode="fill"`` gather nor its ``mode="drop"``
scatter, so both are explicit here: gathers mask out-of-pool indices (K/V
-> 0, positions -> ``PAD_POS``), and every sentinel write is filtered out
before ``index_put_`` (:func:`drop_plan` / :func:`apply_drop`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import PAD_POS

__all__ = [
    "PageAllocator",
    "PageAllocatorError",
    "pages_for",
    "init_paged_cache",
    "view_indices",
    "write_coords",
    "gather_pages",
    "gather_positions",
    "drop_plan",
    "apply_drop",
]


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache slots (at least one)."""
    return max(1, -(-int(n_tokens) // page_size))


class PageAllocatorError(ValueError):
    """Page bookkeeping corruption: double free or foreign-page free."""


class PageAllocator:
    """Free-list allocator over ``n_pages`` physical pages (host-side).

    Pages are ints ``[0, n_pages)``; ``n_pages`` itself is the unmapped
    sentinel of the device block tables.  Tracks a high-water mark.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"need at least one page, got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))  # pop() -> low ids first
        self._free_set = set(self._free)
        self.high_water = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Allocate ``n`` pages or raise ``MemoryError`` (nothing allocated)."""
        if n > len(self._free):
            raise MemoryError(f"{n} pages requested, {len(self._free)} free of {self.n_pages}")
        got = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(got)
        self.high_water = max(self.high_water, self.pages_in_use)
        return got

    def free(self, pages) -> None:
        """Return ``pages``; a foreign or already-free page raises
        :class:`PageAllocatorError`."""
        for p in pages:
            p = int(p)
            if not 0 <= p < self.n_pages:
                raise PageAllocatorError(f"foreign page {p} out of range [0, {self.n_pages})")
            if p in self._free_set:
                raise PageAllocatorError(f"double free of page {p}")
            self._free.append(p)
            self._free_set.add(p)

    def defrag_order(self) -> None:
        """Re-sort the free list so future allocations prefer low page ids."""
        self._free.sort(reverse=True)

    def utilization(self) -> dict:
        return {
            "pages_total": self.n_pages,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.free_pages,
            "high_water": self.high_water,
            "frac_in_use": self.pages_in_use / self.n_pages,
        }


def init_paged_cache(n_layers: int, n_kv_heads: int, head_dim: int, *, n_pages: int,
                     page_size: int, max_batch: int, slot_pages: int,
                     dtype=torch.bfloat16, device="cuda"):
    """Page-pool serve state: ``k/v (L, n_pages, ps, Hkv, Dh)``, ``pos
    (n_pages, ps)`` with ``PAD_POS`` in unwritten slots, ``block_tables
    (max_batch, slot_pages)`` at the ``n_pages`` sentinel, ``len (max_batch,)``."""
    shape = (n_layers, n_pages, page_size, n_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((n_pages, page_size), PAD_POS, dtype=torch.int32, device=device),
        "block_tables": torch.full((max_batch, slot_pages), n_pages, dtype=torch.int32,
                                   device=device),
        "len": torch.zeros((max_batch,), dtype=torch.int32, device=device),
    }


def view_indices(block_tables, page_size: int, lengths=None):
    """Flat indices ``(B, W * page_size)`` of each slot's view into the
    flattened token pool.  Unmapped entries map past the pool end.  With
    ``lengths`` every page-slot at or beyond ``ceil(length / page_size)`` is
    forced to the out-of-pool index ``PAD_POS``, so a stale mapping beyond
    the used length gathers as fill, never as data."""
    bt = block_tables.to(torch.int32)
    offs = torch.arange(page_size, dtype=torch.int32, device=bt.device)
    flat = bt[:, :, None] * page_size + offs
    if lengths is not None:
        used = (lengths.to(torch.int32) + page_size - 1) // page_size
        slot = torch.arange(bt.shape[1], dtype=torch.int32, device=bt.device)
        live = slot[None, :] < used[:, None]
        flat = torch.where(live[:, :, None], flat, PAD_POS)
    return flat.reshape(bt.shape[0], -1)


def write_coords(block_tables, logical_slots, valid, n_pages: int, page_size: int):
    """Physical ``(page, offset)`` of logical cache slots ``(B,)`` or
    ``(B, C)``; invalid tokens, unmapped entries and slots past the table
    end resolve to the ``n_pages`` drop sentinel."""
    W = block_tables.shape[1]
    tbl_raw = torch.div(logical_slots, page_size, rounding_mode="floor")
    tbl = tbl_raw.clamp(0, W - 1).long()
    rows = torch.arange(block_tables.shape[0], device=block_tables.device)
    page = block_tables[rows[:, None], tbl] if logical_slots.ndim == 2 else block_tables[rows, tbl]
    ok = valid & (tbl_raw < W) & (page < n_pages)
    page = torch.where(ok, page, torch.full_like(page, n_pages))
    return page, torch.remainder(logical_slots, page_size).to(page.dtype)


def _in_pool(flat_view, size: int):
    return (flat_view >= 0) & (flat_view < size)


def gather_pages(pool, flat_view):
    """Gather ``pool (n_pages, ps, ...)`` into views ``(B, V, ...)``;
    out-of-pool indices fill with zeros."""
    flat_pool = pool.reshape((-1,) + tuple(pool.shape[2:]))
    ok = _in_pool(flat_view, flat_pool.shape[0])
    got = flat_pool[torch.where(ok, flat_view, 0).long()]
    return torch.where(ok.reshape(ok.shape + (1,) * (got.ndim - 2)), got, 0).to(pool.dtype)


def gather_positions(pos_pool, flat_view):
    """Gather the position pool into views ``(B, V)``; unmapped -> ``PAD_POS``."""
    flat = pos_pool.reshape(-1)
    ok = _in_pool(flat_view, flat.shape[0])
    return torch.where(ok, flat[torch.where(ok, flat_view, 0).long()], PAD_POS)


def drop_plan(index: tuple, bounds: tuple):
    """Plan of a scatter with JAX's ``mode="drop"`` semantics.

    ``index`` tensors broadcast to one shape ``S``; every element whose index
    is outside ``[0, bound)`` on any indexed dim is dropped.  Returns
    ``(kept index tuple, flat source rows)`` for :func:`apply_drop`.  The
    plan costs one host sync (the kept count); a model step builds it once
    and reuses it for every layer's write.
    """
    shape = torch.broadcast_shapes(*(i.shape for i in index))
    idx = [torch.broadcast_to(i, shape).reshape(-1) for i in index]
    keep = torch.ones(idx[0].shape, dtype=torch.bool, device=idx[0].device)
    for i, bound in zip(idx, bounds):
        keep &= (i >= 0) & (i < bound)
    rows = keep.nonzero()[:, 0]
    return tuple(i[rows].long() for i in idx), rows


def apply_drop(dst, plan, values) -> None:
    """``dst[index] = values`` in place for the kept elements of ``plan``;
    ``values`` has shape ``S`` plus the trailing dims of ``dst``."""
    sel, rows = plan
    flat = values.reshape((-1,) + tuple(dst.shape[len(sel):]))
    dst.index_put_(sel, flat[rows].to(dst.dtype))


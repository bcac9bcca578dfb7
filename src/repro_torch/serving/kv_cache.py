"""Paged KV cache: page allocator, content-addressed prefix index, pool
state and page-table arithmetic (port of ``repro.serving.kv_cache``).

KV lives in fixed-size pages drawn from one shared pool; each slot holds a
block table mapping its logical token positions to pages.  An unmapped
block-table entry holds ``n_pages`` (one past the last page).

With ``sp_degree = P > 1`` the cache is sequence-sharded over the ranks of
the context's ring (:func:`sp_ranks`):

* the **dense slab** ``(B, Smax)``: rank ``r`` holds the contiguous slots
  ``[r*S_loc, (r+1)*S_loc)``, ``S_loc = Smax / P``.  The virtual ring keeps
  every rank's shard rank-major, ``(P*B, S_loc)`` (rank ``r``'s rows
  ``[r*B, (r+1)*B)``, the layout its kernels read with no copy); a process
  group holds its own ``(B, S_loc)``.  :func:`dense_write_index` maps global
  ``(slot row, position)`` writes into that layout;
* the **page pool**: rank ``r`` holds the stripe of global pages
  ``[r*n_local, (r+1)*n_local)``, ``n_local = n_pages / P``.  The virtual
  ring keeps the whole pool; a process group allocates only its stripe, and
  :func:`local_pages` / :func:`stripe_view` map global page ids and view
  indices into it.  Block tables and lengths stay global and replicated.

Torch has neither JAX's ``mode="fill"`` gather nor its ``mode="drop"``
scatter, so both are explicit here: gathers mask out-of-pool indices (K/V
-> 0, positions -> ``PAD_POS``), and every sentinel write is filtered out
before ``index_put_`` (:func:`drop_plan` / :func:`apply_drop`).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels.ref import PAD_POS

__all__ = [
    "PageAllocator",
    "PageAllocatorError",
    "PrefixHit",
    "PrefixIndex",
    "pages_for",
    "init_paged_cache",
    "view_indices",
    "write_coords",
    "gather_pages",
    "gather_positions",
    "drop_plan",
    "apply_drop",
    "sp_ranks",
    "dense_write_index",
    "dense_slot_rows",
    "local_pages",
    "stripe_view",
    "dense_cache_bytes",
    "paged_cache_bytes",
]


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache slots (at least one)."""
    return max(1, -(-int(n_tokens) // page_size))


class PageAllocatorError(ValueError):
    """Page bookkeeping corruption: double free or foreign-page free."""


class PageAllocator:
    """Free-list allocator over ``n_pages`` physical pages (host-side).

    Pages are ints ``[0, n_pages)``; ``n_pages`` itself is the unmapped
    sentinel of the device block tables.  Tracks a high-water mark and, with
    ``stripes > 1`` (the SP degree), the pages each rank's stripe held at
    it.
    """

    def __init__(self, n_pages: int, stripes: int = 1):
        if n_pages < 1:
            raise ValueError(f"need at least one page, got {n_pages}")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))  # pop() -> low ids first
        self._free_set = set(self._free)
        self.high_water = 0
        self._stripe = max(1, n_pages // stripes)
        self._in_stripe = [0] * stripes
        self.stripes_at_high_water = list(self._in_stripe)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def free_set(self) -> frozenset:
        """The free pages as a set (read-only view for invariant audits)."""
        return frozenset(self._free_set)

    def alloc(self, n: int) -> list[int]:
        """Allocate ``n`` pages or raise ``MemoryError`` (nothing allocated)."""
        if n > len(self._free):
            raise MemoryError(f"{n} pages requested, {len(self._free)} free of {self.n_pages}")
        got = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(got)
        for p in got:
            self._in_stripe[min(p // self._stripe, len(self._in_stripe) - 1)] += 1
        if self.pages_in_use > self.high_water:
            self.high_water = self.pages_in_use
            self.stripes_at_high_water = list(self._in_stripe)
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
            self._in_stripe[min(p // self._stripe, len(self._in_stripe) - 1)] -= 1

    def defrag_order(self) -> None:
        """Re-sort the free list so future allocations prefer low page ids."""
        self._free.sort(reverse=True)

    def utilization(self) -> dict:
        out = {
            "pages_total": self.n_pages,
            "pages_in_use": self.pages_in_use,
            "pages_free": self.free_pages,
            "high_water": self.high_water,
            "frac_in_use": self.pages_in_use / self.n_pages,
        }
        if len(self._in_stripe) > 1:
            out["stripes_at_high_water"] = list(self.stripes_at_high_water)
        return out


# ---------------------------------------------------------------------------
# content-addressed prefix index (host-side, like the allocator)
# ---------------------------------------------------------------------------


@dataclass
class PrefixHit:
    """Result of :meth:`PrefixIndex.lookup` for one request's token ids.

    ``pages``: resident pages whose *full* pages match the request's prefix,
    in chain order.  ``cow_page``/``cow_keep``: when the first divergence
    falls inside a resident page, the page to copy and how many of its
    leading rows are still valid (copy-on-write).  ``tokens`` is
    ``len(pages) * page_size + cow_keep``.
    """

    pages: list[int]
    tokens: int
    cow_page: int | None = None
    cow_keep: int = 0


class PrefixIndex:
    """Content-addressed index over resident KV pages (host-side).

    Every full page of a prefilled prompt is keyed by a hash chain over its
    token ids, ``key_i = sha256(key_{i-1} || int64 tokens of page i)``, so a
    key names the page's tokens and its whole left context: two requests
    share page ``i`` iff their first ``(i+1)*ps`` tokens agree.  The chain
    is the JAX index's byte for byte, so both packages give equal keys.

    Pages referenced here are owned by the index, refcounted by the slots
    mapping them; the engine releases them through :meth:`release`, and a
    page returns to the allocator only when :meth:`evict` pops it
    (refcount 0, least recently touched, leaves before interior nodes).  A
    divergence inside a page is never resolved by writing the shared page:
    :meth:`lookup` reports it as a copy-on-write candidate.
    """

    ROOT = b""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._page_of: dict[bytes, int] = {}  # key -> physical page
        self._key_of: dict[int, bytes] = {}  # physical page -> key
        self._refs: dict[int, int] = {}  # physical page -> mapping slots
        self._tokens: dict[bytes, tuple[int, ...]] = {}  # key -> page tokens
        self._children: dict[bytes, set[bytes]] = {}  # parent key -> keys
        self._parent: dict[bytes, bytes] = {}  # key -> parent key
        self._touch: dict[bytes, int] = {}  # key -> LRU tick
        self._tick = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.cow_copies = 0
        self.evictions = 0

    @property
    def pages(self) -> set[int]:
        """Physical pages the index currently owns."""
        return set(self._key_of)

    def refcount(self, page: int) -> int:
        """Live mappings of ``page`` (0 = resident but evictable)."""
        return self._refs.get(int(page), 0)

    def total_refs(self) -> int:
        return sum(self._refs.values())

    def _chain_keys(self, tokens) -> list[bytes]:
        """Hash-chain keys of every full page of ``tokens``."""
        ids = [int(t) for t in tokens]
        keys = []
        key = self.ROOT
        ps = self.page_size
        for i in range(len(ids) // ps):
            h = hashlib.sha256(key)
            h.update(np.asarray(ids[i * ps:(i + 1) * ps], np.int64).tobytes())
            key = h.digest()
            keys.append(key)
        return keys

    def _note(self, key: bytes) -> None:
        self._tick += 1
        self._touch[key] = self._tick

    def lookup(self, tokens) -> PrefixHit:
        """Longest reusable prefix of ``tokens`` among resident pages: the
        chain walk while keys resolve, then the longest shared run inside
        the divergence page among the matched tail's children (the COW
        candidate; only a strictly partial match; the first in key order
        among equally long runs, where the JAX index takes the first in its
        set's order)."""
        ids = [int(t) for t in tokens]
        ps = self.page_size
        pages: list[int] = []
        parent = self.ROOT
        for key in self._chain_keys(ids):
            page = self._page_of.get(key)
            if page is None:
                break
            pages.append(page)
            parent = key
            self._note(key)
        hit = len(pages) * ps
        cow_page, cow_keep = None, 0
        rest = ids[hit:]
        if rest:
            # children in key order, not set order: ranks of a process
            # group hash bytes with their own seeds, yet must pick the same
            # candidate among equally long runs
            for child in sorted(self._children.get(parent, ())):
                common = 0
                for a, b in zip(rest, self._tokens[child]):
                    if a != b:
                        break
                    common += 1
                if cow_keep < common < ps:
                    cow_page, cow_keep = self._page_of[child], common
        self.lookup_tokens += len(ids)
        self.hit_tokens += hit + cow_keep
        return PrefixHit(pages=pages, tokens=hit + cow_keep, cow_page=cow_page,
                         cow_keep=cow_keep)

    def acquire(self, pages) -> None:
        """Map index-owned ``pages`` into one more slot (refcount += 1)."""
        for p in pages:
            p = int(p)
            if p not in self._key_of:
                raise ValueError(f"page {p} is not index-owned")
            self._refs[p] += 1
            self._note(self._key_of[p])

    def register(self, tokens, pages) -> int:
        """Index a prefilled prompt's full pages (``pages``: the request's
        block-table pages in logical order), claiming this request's mapping
        as one reference each.  A key already resident is skipped (the
        duplicate page stays private).  Returns the pages newly indexed."""
        ids = [int(t) for t in tokens]
        ps = self.page_size
        new = 0
        parent = self.ROOT
        for i, (key, page) in enumerate(zip(self._chain_keys(ids), pages)):
            page = int(page)
            if key not in self._page_of:
                if page in self._key_of:
                    raise ValueError(f"page {page} already indexed under another key")
                self._page_of[key] = page
                self._key_of[page] = key
                self._refs[page] = 1
                self._tokens[key] = tuple(ids[i * ps:(i + 1) * ps])
                self._parent[key] = parent
                self._children.setdefault(parent, set()).add(key)
                self._note(key)
                new += 1
            parent = key
        return new

    def release(self, page) -> bool:
        """Drop one slot's mapping of ``page``: True when the page is
        index-owned (the caller must not free it), False for a private page
        the caller frees."""
        page = int(page)
        key = self._key_of.get(page)
        if key is None:
            return False
        if self._refs[page] <= 0:
            raise ValueError(f"release of page {page} with refcount 0")
        self._refs[page] -= 1
        self._note(key)
        return True

    def evict(self, n: int, keep=()) -> list[int]:
        """Un-index up to ``n`` refcount-0 pages, least recently touched
        first with leaves before interior nodes, never a page of ``keep``
        (an admission's hit, not acquired yet); the caller resets their
        position rows and frees them to the allocator."""
        keep = set(keep)
        out: list[int] = []
        while len(out) < n:
            candidates = [key for key, page in self._page_of.items()
                          if self._refs[page] == 0 and page not in keep]
            if not candidates:
                break
            candidates.sort(key=lambda k: (bool(self._children.get(k)), self._touch[k]))
            out.append(self._drop(candidates[0]))
        self.evictions += len(out)
        return out

    def _drop(self, key: bytes) -> int:
        page = self._page_of.pop(key)
        del self._key_of[page]
        del self._refs[page]
        del self._tokens[key]
        parent = self._parent.pop(key)
        kids = self._children.get(parent)
        if kids:
            kids.discard(key)
            if not kids:
                del self._children[parent]
        self._children.pop(key, None)
        self._touch.pop(key, None)
        return page

    def stats(self) -> dict:
        rate = self.hit_tokens / self.lookup_tokens if self.lookup_tokens else 0.0
        return {
            "indexed_pages": len(self._key_of),
            "shared_refs": self.total_refs(),
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "hit_rate": rate,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
        }

    def export_state(self) -> dict:
        """JSON-safe snapshot of the whole index (the JAX index's format):
        chain keys (hex), pages, refcounts, tokens, parent links, LRU ticks."""
        return {
            "page_size": self.page_size,
            "pages": [
                {
                    "key": key.hex(),
                    "page": page,
                    "tokens": list(self._tokens[key]),
                    "parent": self._parent[key].hex(),
                    "refs": self._refs[page],
                    "touch": self._touch.get(key, 0),
                }
                for key, page in self._page_of.items()
            ],
            "tick": self._tick,
            "counters": {
                "hit_tokens": self.hit_tokens,
                "lookup_tokens": self.lookup_tokens,
                "cow_copies": self.cow_copies,
                "evictions": self.evictions,
            },
        }

    @classmethod
    def from_state(cls, blob: dict) -> "PrefixIndex":
        """Rebuild an index from :meth:`export_state` output."""
        idx = cls(int(blob["page_size"]))
        for rec in blob["pages"]:
            key = bytes.fromhex(rec["key"])
            parent = bytes.fromhex(rec["parent"])
            page = int(rec["page"])
            idx._page_of[key] = page
            idx._key_of[page] = key
            idx._refs[page] = int(rec["refs"])
            idx._tokens[key] = tuple(int(t) for t in rec["tokens"])
            idx._parent[key] = parent
            idx._children.setdefault(parent, set()).add(key)
            idx._touch[key] = int(rec["touch"])
        idx._tick = int(blob["tick"])
        for name, value in blob["counters"].items():
            setattr(idx, name, int(value))
        return idx


def sp_ranks(pctx) -> tuple[int, int | None]:
    """``(P, rank)`` of a context's cache layout: ``rank`` is ``None`` where
    one process holds every rank (one device, or the virtual ring) and the
    process group's rank otherwise."""
    if pctx is None or not pctx.active:
        return 1, None
    return pctx.sp_degree, (None if pctx.ring.folded else pctx.ring.rank)


def init_paged_cache(n_layers: int, n_kv_heads: int, head_dim: int, *, n_pages: int,
                     page_size: int, max_batch: int, slot_pages: int,
                     dtype=torch.bfloat16, device="cuda", pctx=None):
    """Page-pool serve state: ``k/v (L, n_pages, ps, Hkv, Dh)``, ``pos
    (n_pages, ps)`` with ``PAD_POS`` in unwritten slots, ``block_tables
    (max_batch, slot_pages)`` at the ``n_pages`` sentinel, ``len (max_batch,)``.

    With an active ``pctx`` the pages stripe across the ring (``n_pages``
    must be a multiple of the SP degree); on a process group the pools hold
    only this rank's ``n_pages / P`` pages, the tables stay global."""
    P, rank = sp_ranks(pctx)
    if P > 1 and n_pages % P:
        raise ValueError(
            f"paged pool: n_pages={n_pages} must be a multiple of the SP "
            f"degree {P} so pages stripe evenly across the "
            "ring"
        )
    held = n_pages if rank is None else n_pages // P
    shape = (n_layers, held, page_size, n_kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((held, page_size), PAD_POS, dtype=torch.int32, device=device),
        "block_tables": torch.full((max_batch, slot_pages), n_pages, dtype=torch.int32,
                                   device=device),
        "len": torch.zeros((max_batch,), dtype=torch.int32, device=device),
    }


def dense_write_index(rows, slots, *, batch: int, s_loc: int, P: int, rank: int | None):
    """Index and bounds of writes to the dense slab at global ``(row,
    slot)`` in the SP layout (module docstring), for :func:`drop_plan`:
    slot ``s`` lives on rank ``s // s_loc`` at local slot ``s % s_loc``.  A
    slot at or past ``P * s_loc`` (the drop sentinel), or on another rank of
    a process group, is dropped."""
    r = torch.div(slots, s_loc, rounding_mode="floor")
    local = torch.remainder(slots, s_loc)
    if rank is None:
        return (r * batch + rows, local), (P * batch, s_loc)
    return (rows + torch.zeros_like(local), torch.where(r == rank, local, s_loc)), (batch, s_loc)


def dense_slot_rows(slot: int, batch: int, P: int, rank: int | None) -> list[int]:
    """Rows of the dense slab's position table that hold slot ``slot``."""
    return [slot] if rank is not None else [r * batch + slot for r in range(P)]


def local_pages(pages, n_pages: int, P: int, rank: int | None):
    """Global page ids into the ids of the pool this process holds: the same
    where it holds the whole pool; on a process group ``page - lo`` for the
    rank's stripe and the local sentinel ``n_pages / P`` for every other
    page (and for the global sentinel)."""
    if rank is None:
        return pages
    n_local = n_pages // P
    lo = rank * n_local
    return torch.where((pages >= lo) & (pages < lo + n_local), pages - lo, n_local)


def stripe_view(flat_view, n_pages: int, page_size: int, P: int, rank: int | None):
    """Flat view indices (:func:`view_indices`, global) of each rank's own
    pages, every other entry out of the pool (it gathers as fill): on a
    process group ``(B, V)`` into the rank's stripe, on the virtual ring
    ``(P*B, V)`` in folded order into the whole pool."""
    if P == 1:
        return flat_view
    span = n_pages // P * page_size
    owner = torch.div(flat_view, span, rounding_mode="floor")
    live = (flat_view >= 0) & (flat_view < n_pages * page_size)
    if rank is not None:
        return torch.where(live & (owner == rank), flat_view - rank * span, PAD_POS)
    ranks = torch.arange(P, device=flat_view.device)[:, None, None]
    folded = torch.where(live[None] & (owner[None] == ranks), flat_view[None], PAD_POS)
    return folded.reshape(-1, flat_view.shape[1])


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



def dense_cache_bytes(cfg, max_batch: int, max_len: int) -> int:
    """Bytes the dense slab pins for its whole life: worst case, always."""
    from repro_torch.core.strategies import itemsize

    return (2 * cfg.n_layers * max_batch * max_len * cfg.n_kv_heads * cfg.head_dim
            * itemsize(cfg.dtype))


def paged_cache_bytes(cfg, n_pages: int, page_size: int) -> int:
    """Bytes ``n_pages`` pool pages hold (at the allocator's ``high_water``
    for the achieved footprint, at the pool size for the cap)."""
    from repro_torch.core.strategies import itemsize

    return (2 * cfg.n_layers * n_pages * page_size * cfg.n_kv_heads * cfg.head_dim
            * itemsize(cfg.dtype))

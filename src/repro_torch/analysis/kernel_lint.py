"""Hopper kernel lints (counterpart of ``repro.analysis.kernel_lint``): the
port's own kernel instances against the card's limits, and their grids and
skip predicates against exhaustive visibility.

The reference prices Pallas BlockSpecs against a TPU core's 16 MiB VMEM.
On an H100 a block has at most 227 KB of shared memory, registers are the
scarcer resource, and the decode core's cluster instance needs its
clusters resident at once, so the rules are redesigned:

  * ``KERN-SMEM`` — :func:`smem_estimate` is a closed form of each
    instance's dynamic shared memory, written from the layouts in
    ``csrc/`` (``flash_fwd.cu`` ``Smem<D>::bytes``, ``core::Fwd<T, D>``;
    ``flash_bwd.cu`` ``core::Dq<T, D>``, ``core::Dkv<T, D>``,
    ``DqSmem<D>``, ``DkvSmem<D>``; ``decode.cuh`` ``Shape::smem_bytes``;
    ``decode_d256.cuh`` ``Smem::bytes``), held against the block's opt-in
    maximum.  The wgmma instances flag each KV tile (A, B1) or q-tile (B2)
    in shared memory, so the memory grows with the call's length:
    :func:`max_length` is the longest length each admits; one tile past it
    the library refuses the launch (``cudaErrorInvalidValue``).  On the
    card, ``chip_smoke.py`` holds the closed forms equal to the built
    library's own figures.
  * ``KERN-SPILL`` / ``KERN-WGMMA-SERIAL`` — ptxas's ``-v`` report: a spill
    or a serialised ``wgmma`` (C7512) in any ``*_wgmma_kernel`` fails, a
    spill in the cluster instance or in A's, B1's and B2's CUDA-core
    kernels (``*_core_kernel``) fails; the split decode kernel is not
    gated.
  * ``KERN-CLUSTER`` — a call on the cluster instance launches ``units``
    clusters of ``G`` blocks (``decode_rule_d256``); it fires when that is
    more than the card holds at once.
  * ``KERN-GRID-COVER`` — each instance's tiles (``wgmma_fwd_tiling``,
    ``wgmma_bwd_tiling``, ``core_fwd_tiling``, ``core_dq_tiling``,
    ``core_dkv_tiling``, the decode core's 32-key
    tiles and ``DECODE_MAX_ROWS`` row chunks) cover every row and key once.
    Every CUDA instance masks a ragged last tile, so a ragged tail is
    allowed (:func:`ragged`), not a finding; the decode rules' splits and
    clusters must cover the key tiles exactly.
  * ``PRE-TILE-DIV`` — the tiles of the plain versions, which
    ``ops.flash_attention`` validates for every implementation.
  * ``KERN-LIVE-SKIP`` — the kernels' ``tile_skip`` against ``tile_mask``,
    exhaustively per element.
  * ``KERN-PAGED-BOUNDS`` / ``KERN-PAGED-SENTINEL`` — the decode core's
    block-table address rule (``paged_attention.page_read``) over a
    serving-shaped table with a sentinel and a corrupt entry, and
    ``page_skip`` probed with aliased live positions.

:class:`CardLimits` holds what the lints read of the card: ``H100`` the
documented and measured figures for a CPU run, :func:`card_limits` the
card's own.  Nothing here launches a kernel.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from repro_torch.analysis.preconditions import check_tile_divisible, finding
from repro_torch.analysis.report import Finding
from repro_torch.kernels.flash_attention import (
    CORE_FLAG_CHUNK,
    CORE_STAGES,
    DECODE_D256_MAX_CLUSTER,
    DECODE_MAX_ROWS,
    DECODE_MAX_SPLIT_TILES,
    DECODE_TILE_KEYS,
    decode_core_instance,
    decode_rule_d256,
    decode_split_rule,
    decode_units,
    core_dkv_tiling,
    core_dq_tiling,
    core_fwd_tiling,
    flash_bwd_instance,
    flash_fwd_instance,
    tile_mask,
    tile_skip,
    wgmma_bwd_tiling,
    wgmma_fwd_tiling,
)

__all__ = [
    "KMAX_SMEM",
    "CardLimits",
    "H100",
    "card_limits",
    "INSTANCES",
    "smem_estimate",
    "max_length",
    "smem_findings",
    "grid_findings",
    "instance_tiles",
    "ragged",
    "decode_cover_findings",
    "cluster_findings",
    "tile_skip_findings",
    "paged_bounds_findings",
    "paged_sentinel_findings",
    "lint_flash_call",
    "lint_paged_decode_config",
    "CLUSTER_SIZES",
    "gated",
    "ptxas_functions",
    "ptxas_findings",
    "ptxas_wgmma_faults",
    "CLUSTER_KERNEL",
    "CORE_KERNELS",
]

# The opt-in maximum the library sets and checks every launch against
# (kMaxSmem in flash_fwd.cu, flash_bwd.cu and decode.cuh).
KMAX_SMEM = 232448
# Cluster sizes the cluster instance can launch (powers of two up to
# DECODE_D256_MAX_CLUSTER), and the next size, which the rule refuses.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
_STAGES = 2  # K/V (A, B1) and Q/dout (B2) stages of the wgmma instances
_SPLIT_STAGES = 3  # the split decode kernel's cp.async ring
_MAX_GRID_Y = 65535  # splits of one decode launch (gridDim.y)


@dataclass(frozen=True)
class CardLimits:
    """What the lints read of the card: the block's opt-in shared memory,
    the SM count, and how many clusters of each size of the cluster
    instance the card holds at once (``cudaOccupancyMaxActiveClusters`` at
    the instance's shared memory)."""

    name: str
    smem_optin: int
    sm_count: int
    clusters: dict

    def to_json(self) -> dict:
        return {"name": self.name, "smem_optin": self.smem_optin, "sm_count": self.sm_count,
                "clusters": {str(g): n for g, n in sorted(self.clusters.items())}}


# An H100 SXM: 232,448 B a block and 132 SMs (NVIDIA's data sheet); the
# clusters of the cluster instance it holds at once, as
# `decode_cluster_occupancy` read them on an NVIDIA H100 80GB HBM3 at 700 W
# (clusters of 4 pack into its GPCs less well than 132 / 4).
H100 = CardLimits(
    name="H100 (documented figures)", smem_optin=232448, sm_count=132,
    clusters={1: 132, 2: 66, 4: 30, 8: 15, 16: 7},
)


def card_limits(device=0) -> CardLimits:
    """The card's own limits (builds the library on first use; needs the
    card)."""
    from repro_torch.kernels.flash_attention import decode_cluster_occupancy

    props = torch.cuda.get_device_properties(device)
    return CardLimits(
        name=torch.cuda.get_device_name(device),
        smem_optin=props.shared_memory_per_block_optin,
        sm_count=props.multi_processor_count,
        clusters={g: decode_cluster_occupancy(g)[0] for g in CLUSTER_SIZES},
    )


# instance -> (kernel, what its shared memory grows with)
INSTANCES = {
    "fwd_wgmma": ("A", "Sk"),
    "fwd_cuda_core": ("A", None),
    "decode_split": ("A decode, C", "keys of one split"),
    "decode_cluster": ("A decode, C", None),
    "bwd_dq_wgmma": ("B1", "Sk"),
    "bwd_dkv_wgmma": ("B2", "Sq"),
    "bwd_dq_cuda_core": ("B1", None),
    "bwd_dkv_cuda_core": ("B2", None),
}


def _tile_bytes(D: int, rows: int) -> int:
    """``Tile<D, ROWS>::kBytes`` (``csrc/hopper.cuh``): D/64 swizzled regions
    of ``rows`` 128-byte rows of bf16."""
    return (D // 64) * rows * 128


def _wgmma_layout(instance: str, D: int) -> tuple[int, int, int]:
    """``(fixed bytes, bytes a flagged tile, rows or keys a tile)`` of a
    wgmma instance: 1024 bytes of alignment slack, the tiles and mbarriers,
    the q-position range, then one flag a tile."""
    if instance == "fwd_wgmma":  # flash_fwd.cu Smem<D>
        t = wgmma_fwd_tiling(D)
        q, kv = _tile_bytes(D, t["q_rows"]), _tile_bytes(D, t["keys"])
        bars = q + 2 * _STAGES * kv
        return 1024 + bars + 8 * (2 * _STAGES + 1) + 8, 4, t["keys"]
    t = wgmma_bwd_tiling(D)
    if instance == "bwd_dq_wgmma":  # flash_bwd.cu DqSmem<D>: Q, dout, K/V stages
        q, kv = _tile_bytes(D, t["dq_rows"]), _tile_bytes(D, t["dq_keys"])
        bars = 2 * q + 2 * _STAGES * kv
        return 1024 + bars + 8 * (2 * _STAGES + 1) + 8, 1, t["dq_keys"]
    if instance == "bwd_dkv_wgmma":  # DkvSmem<D>: K, V, Q/dout stages, P stages
        kv, q = _tile_bytes(D, t["dkv_keys"]), _tile_bytes(D, t["dkv_rows"])
        bars = 2 * kv + 2 * _STAGES * q + _STAGES * t["dkv_keys"] * t["dkv_rows"] * 4
        return 1024 + bars + 8 * (3 * _STAGES + 1) + 8, 1, t["dkv_rows"]
    raise ValueError(f"{instance!r} is not a wgmma instance")


def _split_rows(D: int, rows: int) -> tuple[int, int] | None:
    """``(WR, RW)`` of the split decode kernel's layout for ``rows`` a KV
    head (``by_rows`` in ``csrc/decode.cuh``), or None where it takes none."""
    if D == 256:
        return (4, 4) if rows <= 16 else None
    r = min(rows, DECODE_MAX_ROWS)
    for limit, layout in ((2, (1, 2)), (4, (1, 4)), (8, (2, 4)), (16, (4, 4)), (32, (4, 8))):
        if r <= limit:
            return layout
    return (4, 16)


def smem_estimate(instance: str, D: int, S: int = 0, *, dtype=torch.bfloat16, rows: int = 1,
                  paged: bool = False) -> int:
    """Dynamic shared memory (bytes) of one block of ``instance`` at head
    dim ``D``.  ``S`` is the length the instance's memory grows with
    (``INSTANCES``): ``Sk`` for A's and B1's wgmma instances, ``Sq`` for
    B2's, the keys of one split for the split decode kernel (``rows``: GQA
    group x Sq; ``dtype``; ``paged`` for kernel C); the others ignore it.
    ``dtype`` also sets the staged type of the CUDA-core instances (bf16
    at D 32, else float32)."""
    if instance in ("fwd_wgmma", "bwd_dq_wgmma", "bwd_dkv_wgmma"):
        fixed, per_tile, tile = _wgmma_layout(instance, D)
        return fixed + per_tile * -(-S // tile)
    # The CUDA-core instances stage K/V (A, B1) or Q/dout (B2) in the
    # call's type, which is bf16 only at D 32 (the only bf16 instance)
    item = 2 if dtype == torch.bfloat16 and D == 32 else 4
    listing = 4 * CORE_FLAG_CHUNK + CORE_FLAG_CHUNK + 16  # live tiles, flags, misc
    if instance == "fwd_cuda_core":  # flash_fwd.cu core::Fwd<T, D>
        c = core_fwd_tiling(D)
        bq, bk = c["q_rows"], c["keys"]
        ring = CORE_STAGES * 2 * bk * (D + 16 // item) * item
        return (4 * bq * (D + 4) + ring + 4 * bq * (bk + 16) + 4 * CORE_STAGES * bk + 4 * bq
                + listing)
    if instance == "bwd_dq_cuda_core":  # flash_bwd.cu core::Dq<T, D>
        c = core_dq_tiling(D)
        bq, bk = c["q_rows"], c["keys"]
        ring = CORE_STAGES * 2 * bk * (D + 16 // item) * item
        return (2 * 4 * bq * (D + 4) + ring + 4 * bq * (bk + 16) + 4 * CORE_STAGES * bk
                + 4 * 4 * bq + listing)
    if instance == "bwd_dkv_cuda_core":  # flash_bwd.cu core::Dkv<T, D>
        c = core_dkv_tiling(D)
        bk, bq = c["keys"], c["q_rows"]
        ring = CORE_STAGES * (2 * bq * (D + 16 // item) * item + 16 * bq)
        return 2 * 4 * bk * (D + 4) + ring + 2 * 4 * bk * (bq + 16) + 4 * bk + listing
    if instance == "decode_split":  # decode.cuh Shape<T, D, WR, RW, kPaged>
        layout = _split_rows(D, rows)
        if layout is None:
            raise ValueError(f"the split decode kernel takes no {rows} rows at D {D}")
        rb = layout[0] * layout[1]
        tps = max(1, -(-S // DECODE_TILE_KEYS))
        itemsize = torch.empty((), dtype=dtype).element_size()
        ring = _SPLIT_STAGES * 2 * DECODE_TILE_KEYS * D * itemsize
        return ring + 4 * rb * D + 4 * (rb + tps * DECODE_TILE_KEYS * (2 if paged else 1)
                                        + tps + 2)
    if instance == "decode_cluster":  # decode_d256.cuh Smem
        stages, rows16 = 4, 16
        q = stages * 2 * _tile_bytes(256, DECODE_TILE_KEYS)
        pos = q + _tile_bytes(256, rows16)
        flag = pos + stages * DECODE_TILE_KEYS * 4
        bars = flag + stages * 4
        return 1024 + bars + 16 * stages
    raise ValueError(f"unknown kernel instance {instance!r}; expected one of {sorted(INSTANCES)}")


def max_length(instance: str, D: int, budget: int = KMAX_SMEM) -> int | None:
    """The longest length (``INSTANCES``) a wgmma instance admits within
    ``budget`` bytes; None where the memory does not grow with the call
    (the split decode kernel's splits stop at ``DECODE_MAX_SPLIT_TILES``
    tiles, so its calls are bounded by the grid, not the memory)."""
    if instance not in ("fwd_wgmma", "bwd_dq_wgmma", "bwd_dkv_wgmma"):
        return None
    fixed, per_tile, tile = _wgmma_layout(instance, D)
    return (budget - fixed) // per_tile * tile


def smem_findings(instance: str, D: int, S: int = 0, *, limits: CardLimits = H100,
                  subject: str, **kw) -> list[Finding]:
    """KERN-SMEM: the instance's memory at the call within the block's
    opt-in maximum (the card's, and the library's ``KMAX_SMEM``)."""
    est = smem_estimate(instance, D, S, **kw)
    budget = min(limits.smem_optin, KMAX_SMEM)
    if est <= budget:
        return []
    longest = max_length(instance, D, budget)
    tail = f"; it admits {INSTANCES[instance][1]} up to {longest}" if longest else ""
    return [Finding("KERN-SMEM", subject,
                    f"{instance} at D={D}, {INSTANCES[instance][1] or 'any length'}={S} needs "
                    f"{est} B of shared memory a block (opt-in maximum {budget} B){tail}")]


def card_smem_findings(limits: CardLimits, *, subject: str) -> list[Finding]:
    """KERN-SMEM: the library opts every instance in to ``KMAX_SMEM``; a
    card that allows less refuses the attribute."""
    if limits.smem_optin >= KMAX_SMEM:
        return []
    return [Finding("KERN-SMEM", subject,
                    f"the card allows {limits.smem_optin} B of shared memory a block; the "
                    f"library opts in to {KMAX_SMEM} B")]


def ragged(S: int, block: int) -> bool:
    """Whether ``S`` rows leave a partial last tile of ``block``: every CUDA
    instance masks it (rows past the end read as zero or padding)."""
    return S % block != 0


def grid_findings(Sq: int, Sk: int, *, block_q: int, block_k: int,
                  subject: str) -> list[Finding]:
    """KERN-GRID-COVER: ``ceil(S / block)`` tiles of ``block`` cover every
    row once.  Every CUDA instance masks a ragged last tile (:func:`ragged`
    says where one is), so only a tiling with no rows or keys a tile fires;
    the plain versions' tiles are ``PRE-TILE-DIV``'s."""
    findings: list[Finding] = []
    for axis, S, b in (("q", Sq, block_q), ("kv", Sk, block_k)):
        blk = min(b, S) if S else b
        if blk <= 0:
            findings.append(Finding(
                "KERN-GRID-COVER", subject,
                f"{axis} axis: {S} rows do not tile into {blk}-row blocks "
                f"({S} % {blk} = {S % blk if blk else S}) — some rows would be computed twice "
                f"or never"))
    return findings


def instance_tiles(dtype, D: int, Sq: int) -> tuple[int, int] | None:
    """``(q rows, keys)`` of the tile kernel A's instance walks for a call;
    None on the decode core (its covers are :func:`decode_cover_findings`)."""
    instance = flash_fwd_instance(dtype, Sq, D)
    if instance == "wgmma":
        t = wgmma_fwd_tiling(D)
        return t["q_rows"], t["keys"]
    if instance == "decode":
        return None
    c = core_fwd_tiling(D)
    return c["q_rows"], c["keys"]


def decode_cover_findings(n_keys: int, units: int, *, instance: str, sm_count: int,
                          subject: str, rule=None) -> list[Finding]:
    """KERN-GRID-COVER for the decode core: the split rule's
    (``decode_split_rule``) or the cluster rule's (``decode_rule_d256``)
    blocks cover the call's 32-key tiles exactly once, no block empty, no
    split past ``DECODE_MAX_SPLIT_TILES`` tiles, no cluster past
    ``DECODE_D256_MAX_CLUSTER`` blocks.  ``rule`` is injectable."""
    n_tiles = max(1, -(-n_keys // DECODE_TILE_KEYS))
    if rule is None:
        rule = decode_rule_d256 if instance == "decode_cluster" else decode_split_rule
    per, blocks = rule(n_keys, units, sm_count)
    problems = []
    if not (per >= 1 and (blocks - 1) * per < n_tiles <= blocks * per):
        problems.append(f"{blocks} blocks of {per} tiles do not cover {n_tiles} tiles once")
    if instance == "decode_split":
        if per > DECODE_MAX_SPLIT_TILES:
            problems.append(f"{per} tiles a split pass {DECODE_MAX_SPLIT_TILES}")
        if blocks > _MAX_GRID_Y:
            problems.append(f"{blocks} splits pass the grid's {_MAX_GRID_Y}")
    elif blocks > DECODE_D256_MAX_CLUSTER:
        problems.append(f"a cluster of {blocks} blocks passes {DECODE_D256_MAX_CLUSTER}")
    return [Finding("KERN-GRID-COVER", subject,
                    f"{instance} over {n_keys} keys, {units} units: {p}") for p in problems]


def cluster_findings(units: int, n_keys: int, *, limits: CardLimits = H100,
                     subject: str) -> list[Finding]:
    """KERN-CLUSTER: a call on the cluster instance launches ``units``
    clusters of ``G`` blocks (``decode_rule_d256`` on the card's SMs); more
    than the card holds at once run in a second wave."""
    _, G = decode_rule_d256(n_keys, units, limits.sm_count)
    if G not in limits.clusters:
        raise ValueError(f"no occupancy for clusters of {G} in {limits.name}")
    held = limits.clusters[G]
    if units <= held:
        return []
    return [Finding("KERN-CLUSTER", subject,
                    f"{units} clusters of {G} blocks over {n_keys} keys; the card ({limits.name}) "
                    f"holds {held} at once: {-(-units // held)} waves")]


def tile_skip_findings(q_pos, k_pos, *, block_q: int, block_k: int, causal: bool,
                       window: int | None, subject: str, skip_fn=None) -> list[Finding]:
    """KERN-LIVE-SKIP: the skip predicate must never kill a live tile.

    ``q_pos``/``k_pos`` are concrete ``(B, S)`` position layouts (contig,
    zigzag, ring-rotated...), torch or numpy.  ``skip_fn(q_pos_tile,
    k_pos_tile, causal=..., window=...)`` defaults to the kernels' own
    ``tile_skip``; it is injectable so that tests can show the lint catches
    a corrupted predicate.  A ragged last tile is cut short, as the kernels
    mask it.  Visibility is checked exhaustively per element with
    ``tile_mask``."""
    if skip_fn is None:
        skip_fn = tile_skip
    q_pos = torch.as_tensor(q_pos)
    k_pos = torch.as_tensor(k_pos)
    B, Sq = q_pos.shape
    Sk = k_pos.shape[1]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    findings: list[Finding] = []
    for b in range(B):
        for iq, q0 in enumerate(range(0, Sq, bq)):
            qp = q_pos[b, q0:q0 + bq]
            for ik, k0 in enumerate(range(0, Sk, bk)):
                kp = k_pos[b, k0:k0 + bk]
                if not skip_fn(qp, kp, causal=causal, window=window):
                    continue
                if bool(tile_mask(qp, kp, causal=causal, window=window).any()):
                    findings.append(Finding(
                        "KERN-LIVE-SKIP", subject,
                        f"batch {b}, q-tile {iq}, kv-tile {ik} (block_q={bq}, block_k={bk}, "
                        f"causal={causal}, window={window}): predicate skips a tile with "
                        f"visible (query, key) pairs"))
    return findings


def paged_bounds_findings(block_tables, *, n_pages: int, subject: str,
                          read_fn=None) -> list[Finding]:
    """KERN-PAGED-BOUNDS: every pool page the decode core's address rule
    reads lies inside the pool.

    ``read_fn(entry, n_pages)`` defaults to ``paged_attention.page_read``,
    the mirror of the kernels' rule (a page is read only when ``0 <= entry <
    n_pages``; injectable).  It is evaluated over a concrete table that
    holds the unmapped sentinel (``n_pages``) and any corrupt entries the
    caller probes."""
    from repro_torch.kernels.paged_attention import page_read

    if read_fn is None:
        read_fn = page_read
    bad = []
    for b, row in enumerate(torch.as_tensor(block_tables).tolist()):
        for w, entry in enumerate(row):
            page = read_fn(entry, n_pages)
            if page is not None and not 0 <= page < n_pages:
                bad.append((b, w, entry, page))
    if not bad:
        return []
    b, w, entry, page = bad[0]
    return [Finding("KERN-PAGED-BOUNDS", subject,
                    f"the address rule maps table entry {entry} (slot {b}, page {w}) to pool "
                    f"page {page} outside [0, {n_pages}) — an out-of-bounds page read "
                    f"({len(bad)} offending entries)")]


def paged_sentinel_findings(*, n_pages: int, page_size: int, window: int | None = None,
                            subject: str, skip_fn=None) -> list[Finding]:
    """KERN-PAGED-SENTINEL: the paged skip predicate is decided by the raw
    table entry, never by the contents of the page an entry would alias.

    The predicate must (a) skip any ``entry >= n_pages`` even against fully
    visible positions (the sentinel, and a corrupt entry), and (b) never
    skip a mapped page that has visible keys.  ``skip_fn`` defaults to the
    kernel's own ``page_skip`` and is injectable."""
    from repro_torch.kernels.paged_attention import page_mask, page_skip

    if skip_fn is None:
        skip_fn = page_skip
    findings: list[Finding] = []
    # A page of written, causally visible positions, queried from just past
    # its end: the worst case for an aliased sentinel.
    live_pos = torch.arange(page_size, dtype=torch.int32)
    q_pos = page_size
    if not bool(page_mask(live_pos, q_pos, window=window).any()):
        raise ValueError("lint self-check: the probe page must be visible")
    for entry in (n_pages, n_pages + 7):  # sentinel, corrupt
        if not skip_fn(entry, live_pos, q_pos, n_pages=n_pages, window=window):
            findings.append(Finding(
                "KERN-PAGED-SENTINEL", subject,
                f"unmapped table entry {entry} (n_pages={n_pages}) is not skipped against "
                f"live aliased positions — the kernel would attend another request's page"))
    if skip_fn(0, live_pos, q_pos, n_pages=n_pages, window=window):
        findings.append(Finding(
            "KERN-PAGED-SENTINEL", subject,
            f"mapped page 0 with visible keys (q_pos={q_pos}, window={window}) is skipped — "
            f"attention mass silently dropped"))
    return findings


def _decode_findings(*, dtype, D: int, units: int, rows: int, n_keys: int, paged: bool,
                     limits: CardLimits, subject: str) -> list[Finding]:
    """The decode core's lints at one call: the instance's memory at the
    rule's split, its cover, and (cluster) the one-wave rule."""
    instance = "decode_cluster" if decode_core_instance(dtype, D) == "cluster" else "decode_split"
    findings = decode_cover_findings(n_keys, units, instance=instance,
                                     sm_count=limits.sm_count, subject=subject)
    if instance == "decode_cluster":
        findings += smem_findings(instance, D, limits=limits, subject=subject)
        findings += cluster_findings(units, n_keys, limits=limits, subject=subject)
    else:
        per, _ = decode_split_rule(n_keys, units, limits.sm_count)
        findings += smem_findings(instance, D, per * DECODE_TILE_KEYS, limits=limits,
                                  subject=subject, dtype=dtype, rows=rows, paged=paged)
    return findings


def lint_flash_call(*, dtype, D: int, B: int, Sq: int, Sk: int, Hq: int, Hkv: int,
                    subject: str, limits: CardLimits = H100,
                    backward: bool = False) -> list[Finding]:
    """Every kernel lint of one ``ops.flash_attention`` call: kernel A's
    instance (or the decode core's, for ``Sq <= 4``) and, with
    ``backward``, B1's and B2's, at their memory, grids and covers; the
    plain versions' default tiles, which the entry point validates for
    every implementation."""
    from repro_torch.kernels.ops import FlashConfig

    cfg = FlashConfig()
    findings: list[Finding] = []
    for s, b in ((Sq, cfg.block_q), (Sk, cfg.block_k)):
        findings += finding("PRE-TILE-DIV", subject, check_tile_divisible(s, b))
    tiles = instance_tiles(dtype, D, Sq)
    if tiles is None:
        findings += _decode_findings(dtype=dtype, D=D, units=decode_units(B, Hq, Hkv, Sq),
                                     rows=Hq // Hkv * Sq, n_keys=Sk, paged=False,
                                     limits=limits, subject=subject)
    else:
        instance = "fwd_wgmma" if flash_fwd_instance(dtype, Sq, D) == "wgmma" else "fwd_cuda_core"
        findings += smem_findings(instance, D, Sk, limits=limits, subject=subject, dtype=dtype)
        findings += grid_findings(Sq, Sk, block_q=tiles[0], block_k=tiles[1], subject=subject)
    if not backward:
        return findings
    if flash_bwd_instance(dtype, D) == "wgmma":
        t = wgmma_bwd_tiling(D)
        findings += smem_findings("bwd_dq_wgmma", D, Sk, limits=limits, subject=subject)
        findings += smem_findings("bwd_dkv_wgmma", D, Sq, limits=limits, subject=subject)
        findings += grid_findings(Sq, Sk, block_q=t["dq_rows"], block_k=t["dq_keys"],
                                  subject=subject)
        findings += grid_findings(Sq, Sk, block_q=t["dkv_rows"], block_k=t["dkv_keys"],
                                  subject=subject)
    else:
        for inst in ("bwd_dq_cuda_core", "bwd_dkv_cuda_core"):
            findings += smem_findings(inst, D, limits=limits, subject=subject, dtype=dtype)
        for c in (core_dq_tiling(D), core_dkv_tiling(D)):
            findings += grid_findings(Sq, Sk, block_q=c["q_rows"], block_k=c["keys"],
                                      subject=subject)
    return findings


def lint_paged_decode_config(*, dtype, group: int, page_size: int, n_pages: int,
                             table_width: int, D: int, B: int = 1, Hkv: int = 1,
                             window: int | None = None, subject: str,
                             limits: CardLimits = H100) -> list[Finding]:
    """All kernel-C lints at one shape point: the decode core's instance
    over the table's ``table_width * page_size`` keys, and the address rule
    and skip predicate over a table shaped like serving state (pages in
    descending order, the tail unmapped at the sentinel, one corrupt
    entry)."""
    findings = _decode_findings(dtype=dtype, D=D, units=decode_units(B, group * Hkv, Hkv, 1),
                                rows=group, n_keys=table_width * page_size, paged=True,
                                limits=limits, subject=subject)
    bt = torch.full((1, table_width), n_pages, dtype=torch.int32)
    used = min(table_width, n_pages)
    bt[0, :used] = torch.arange(n_pages - used, n_pages, dtype=torch.int32).flip(0)
    if table_width > 1:
        bt[0, table_width - 1] = n_pages + 13  # corrupt entry
    findings += paged_bounds_findings(bt, n_pages=n_pages, subject=subject)
    findings += paged_sentinel_findings(n_pages=n_pages, page_size=page_size, window=window,
                                        subject=subject)
    return findings


# --- ptxas's report --------------------------------------------------------

CLUSTER_KERNEL = "decode_d256_kernel"  # the decode core's cluster instance
# A's, B1's and B2's CUDA-core instances
CORE_KERNELS = ("flash_fwd_core_kernel", "flash_bwd_dq_core_kernel", "flash_bwd_dkv_core_kernel")


def ptxas_functions(text):
    """``{mangled name: {"registers": n, "spill_stores": bytes, "spill_loads":
    bytes, "c7512": bool}}`` from one ``nvcc -Xptxas -v`` log."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = funcs.setdefault(m.group(1), dict(registers=None, spill_stores=0,
                                                    spill_loads=0, c7512=False))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
        if "C7512" in line:
            m = re.search(r"function '([\w$]+)'", line)
            name = m.group(1) if m else cur
            if name is None:
                raise ValueError(f"ptxas: a C7512 warning names no function: {line}")
            funcs.setdefault(name, dict(registers=None, spill_stores=0, spill_loads=0,
                                        c7512=False))["c7512"] = True
    return funcs


def gated(name: str) -> bool:
    """Whether ptxas's report on ``name`` is gated: the wgmma instances of
    A, B1 and B2, the decode core's cluster instance and A's, B1's and B2's
    CUDA-core instances (not the split decode kernel)."""
    return ("wgmma_kernel" in name or CLUSTER_KERNEL in name
            or any(k in name for k in CORE_KERNELS))


def ptxas_findings(logs) -> list[Finding]:
    """KERN-SPILL and KERN-WGMMA-SERIAL over ``logs`` ({library: ptxas
    output}): a spill in a gated instance, and a C7512 in a wgmma
    instance."""
    findings = []
    for lib, text in logs.items():
        for name, f in ptxas_functions(text).items():
            if not gated(name):
                continue
            if f["spill_stores"] or f["spill_loads"]:
                findings.append(Finding("KERN-SPILL", f"{lib}: {name}",
                                        f"spills {f['spill_stores']} B stored, "
                                        f"{f['spill_loads']} B loaded"))
            if f["c7512"]:
                findings.append(Finding("KERN-WGMMA-SERIAL", f"{lib}: {name}",
                                        "has its wgmma serialised (C7512)"))
    return findings


def ptxas_wgmma_faults(logs) -> list[str]:
    """:func:`ptxas_findings` as lines (``library: name`` and what ptxas
    reported); empty when there is none."""
    return [f"{f.subject} {f.detail}" for f in ptxas_findings(logs)]

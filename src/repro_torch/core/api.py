"""Attention API the models call (port of ``repro.core.api``).

Models call :func:`sp_attention` / :func:`sp_decode` with a
:class:`ParallelContext`.  At sequence-parallel (SP) degree 1 attention is
one flash call.  With ``sp_degree > 1`` :meth:`ParallelContext.plan`
resolves the configured strategy (or ``"auto"``, by the registered cost
models' argmin, ``core/strategies.py``) into an :class:`ExecutionPlan` that
runs the strategy's step schedule on the context's ring transport
(``core/collectives.py``):

  * on the **virtual ring** (the default: ``sp_degree`` ranks in one
    process on one device) :func:`sp_attention` takes *global* tensors, as
    the reference does outside ``shard_map``, with the sequence already in
    the layout (e.g. zigzag) the positions describe; it cuts the sequence
    into ``sp_degree`` contiguous shards (rank ``r`` holds shard ``r``),
    folds the ranks into the batch dimension, runs the strategy and puts
    the result back in the global order;
  * on a **process group** (``ring=`` a ``torch.distributed`` group) each
    rank passes its own shard and gets its own shard back.

Built-in (ported) strategies: ``"tokenring"`` (the paper's method,
split-Q bidirectional), ``"tokenring_faithful"`` (Algorithm 1),
``"ring"`` / ``"ring_bidir"`` (baselines) and ``"auto"``.  The reference's
other strategies and its topology-aware and multi-pod (hybrid,
hierarchical) plans raise ``NotImplementedError`` naming the ROADMAP item
that brings them.

Serving (:func:`sp_decode`, :func:`sp_decode_paged`, :func:`sp_prefill`)
keeps the KV cache sequence-sharded and replicates the small query side:
:meth:`ParallelContext.plan_decode` / :meth:`~ParallelContext.plan_prefill`
bind the registered ``"decode"`` / ``"prefill"`` schedules of
``core/decode.py``, whose partials merge in an lse-weighted all-reduce.
The cache comes in the ring's layout: rank-major ``(P*B, Skv/P, ...)`` on
the virtual ring (rank ``r``'s contiguous shard in rows ``[r*B, (r+1)*B)``,
as the serve state keeps it and ``core.collectives.fold_ranks`` makes it
from a global tensor), this rank's shard on a process group; the paged pool
is whole on the virtual ring and the rank's stripe of pages on a process
group.  The query side and the result are replicated.  The plans are built
once per shape and window and kept on the context.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.strategies import (
    UNPORTED,
    CommCost,
    SPStrategy,
    attention_compute_flops,
    get_strategy,
    ineligible_reason,
    not_ported,
    resolve_strategy,
    strategy_cost,
)
from repro_torch.kernels.ref import normalize_positions

__all__ = ["ParallelContext", "ExecutionPlan", "AttnShapes", "sp_attention", "sp_decode",
           "sp_decode_paged", "sp_prefill"]

PREFILL_CANDIDATES = ("prefill", "passkv_ring", "passq_ring")
_PREFILL_RINGS = ("the prefill rings (passkv_ring, passq_ring) and plan_prefill's 'auto' "
                  "arbitration over them are not ported yet: they come with "
                  "core/prefill_rings.py (ROADMAP queue 1 item 8)")
_MULTI_AXIS = ("topology-aware, hierarchical and multi-pod hybrid plans are not ported yet: "
               "they come with core/topology.py, core/hier2d.py and core/hybrid.py "
               "(ROADMAP queue 1 item 8)")


@dataclass(frozen=True)
class AttnShapes:
    """Static attention shapes the planner needs (global, unsharded)."""

    B: int
    Sq: int
    Hq: int
    Hkv: int
    D: int
    Sk: int | None = None  # defaults to Sq (self-attention)
    dtype_bytes: int = 2  # wire size of a q/k/v element

    @property
    def seq_kv(self) -> int:
        return self.Sq if self.Sk is None else self.Sk


@dataclass(frozen=True)
class ExecutionPlan:
    """A validated, resolved SP attention (``kind="attention"``, what
    ``sp_attention`` runs) or serving step (``"decode"``, ``"prefill"``).

    ``local_fn`` is the per-rank callable (strategy schedule and ring
    bound); ``cost`` the strategy's modeled per-device link bytes for one
    forward pass of the layer (one step of a serving plan),
    ``compute_flops`` its per-device attention dot FLOPs (the two halves of
    the ``max(compute, link)`` step model).  ``kernel`` records a serving
    plan's kernel path.
    """

    strategy: str
    local_fn: Callable[..., Any]
    ring: Any
    sp_degree: int
    cost: CommCost | None = None
    compute_flops: float | None = None
    # Whether the schedule's transfers overlap compute (the
    # SPStrategy.pipelines capability).
    pipelines: bool = True
    kind: str = "attention"
    kernel: dict | None = None

    def modeled_times(self, *, link_bw: float, peak_flops: float,
                      bidir_links: bool = True) -> dict | None:
        """Sequential-vs-pipelined modeled wall time of the planned pass:
        ``sequential_s`` charges compute + link, ``pipelined_s`` the
        overlap executor's ``max(compute, link)``."""
        if self.cost is None or self.compute_flops is None:
            return None
        compute_s = self.compute_flops / peak_flops
        seq = self.cost.step_time_s(link_bw, compute_s, bidir_links=bidir_links,
                                    pipelined=False)
        pipe = self.cost.step_time_s(link_bw, compute_s, bidir_links=bidir_links,
                                     pipelined=self.pipelines)
        return {
            "compute_s": compute_s,
            "link_s": self.cost.time_s(link_bw, bidir_links=bidir_links),
            "sequential_s": seq,
            "pipelined_s": pipe,
            "overlap_fraction": (seq - pipe) / seq if seq > 0 else 0.0,
        }

    def __call__(self, *args):
        """An attention plan takes global tensors on a virtual ring and this
        rank's shard on a process group, and returns the result in the same
        form.  A serving plan takes its cache in the ring's layout
        (rank-major on the virtual ring) and a replicated query side, and
        returns the replicated result."""
        from repro_torch.core.collectives import fold_ranks, unfold_ranks

        if self.kind != "attention" or not self.ring.folded:
            return self.local_fn(*args)
        P = self.sp_degree
        return unfold_ranks(self.local_fn(*(fold_ranks(x, P) for x in args)), P)


@dataclass(frozen=True)
class ParallelContext:
    """Static description of how a model instance runs."""

    impl: str = "auto"  # kernel impl: auto | cuda | torch
    block_q: int = 512
    block_k: int = 512
    # Backward tiles of the plain version (None inherits block_q/block_k);
    # kernels B1/B2 tile by their own constants.
    block_q_bwd: int | None = None
    block_k_bwd: int | None = None
    # Decode-path KV tile (None inherits block_k) of the plain version; the
    # fused paged kernel tiles by page.
    block_k_decode: int | None = None
    device: str = "cuda"
    sp_degree: int = 1  # sequence-parallel degree: ranks of the ring
    strategy: str = "tokenring"  # a registered SP strategy or "auto"
    layout: str = "zigzag"  # zigzag | contig (layout of the seq dim in data)
    # Wire format of TokenRing's travelling (out, lse) accumulator:
    # "bfloat16" halves its link bytes at about 1e-3 merge rounding (lse
    # always stays float32).
    travel_dtype: str = "float32"
    # Whether the links carry both ring directions at full rate (NVLink).
    # False makes the planner score total bytes, not max-direction.
    bidir_links: bool = True
    # Post every send of a step before its computes (core/schedule.py).
    # False runs each send after the step's computes; values are bitwise
    # equal either way.
    overlap: bool = True
    # The ring transport: None is the virtual ring of sp_degree ranks on
    # `device`; a torch.distributed process group (or a transport of
    # core.collectives) runs one rank per process.
    ring: Any = None

    def __post_init__(self):
        from repro_torch.core.collectives import ProcessGroupRing, VirtualRing

        ring = self.ring
        if ring is None:
            if self.sp_degree > 1:
                ring = VirtualRing(self.sp_degree, self.device)
        elif not hasattr(ring, "post"):
            ring = ProcessGroupRing(ring)
        if ring is not None and ring.size != self.sp_degree:
            raise ValueError(f"the ring has {ring.size} ranks, sp_degree is {self.sp_degree}")
        object.__setattr__(self, "ring", ring)
        # serving plans by (kind, window, scale, shapes, table_pages): the
        # serving steps ask for the same few plans in every layer of every step
        object.__setattr__(self, "_serving_plans", {})

    @property
    def active(self) -> bool:
        return self.sp_degree > 1

    @property
    def decode_block_k(self) -> int:
        return self.block_k_decode if self.block_k_decode is not None else self.block_k

    # -- planning ----------------------------------------------------------

    def _strategy_kwargs(self, desc: SPStrategy) -> dict:
        """Extras declared by the descriptor, sourced from this context."""
        return {name: getattr(self, name) for name in desc.extra_kwargs if hasattr(self, name)}

    def plan(self, shapes: AttnShapes, *, causal: bool = True, window: int | None = None,
             scale: float | None = None, topology=None) -> ExecutionPlan:
        """Validate the ring and layout and resolve the strategy for these
        shapes into an :class:`ExecutionPlan` (``"auto"`` by the cost models'
        argmin over the ported strategies)."""
        if topology is not None:
            raise NotImplementedError(_MULTI_AXIS)
        if not self.active:
            raise ValueError("planning requires sp_degree > 1")
        P_sp = self.sp_degree
        if shapes.Sq % P_sp or shapes.seq_kv % P_sp:
            raise ValueError(
                f"sequence length {shapes.Sq}/{shapes.seq_kv} not divisible "
                f"by SP degree {P_sp}"
            )
        kw = dict(
            causal=causal, window=window, scale=scale, impl=self.impl,
            block_q=self.block_q, block_k=self.block_k,
            block_q_bwd=self.block_q_bwd, block_k_bwd=self.block_k_bwd,
            overlap=self.overlap,
        )
        name = self.strategy
        # Windowed layers: only window-capable strategies are meaningful, and
        # the one the reference has (core/window.py) is not ported yet.
        if window is not None and (name == "auto" or not get_strategy(name).supports_window):
            raise NotImplementedError(not_ported("window"))
        name = resolve_strategy(
            name, B=shapes.B, S=shapes.Sq, Hq=shapes.Hq, Hkv=shapes.Hkv, D=shapes.D, P=P_sp,
            bytes_per_elem=shapes.dtype_bytes, S_kv=shapes.seq_kv,
            bidir_links=self.bidir_links, layout=self.layout, window=window,
        )
        return self._flat_plan(name, shapes, causal=causal, window=window, kw=kw)

    def _flat_plan(self, name: str, shapes: AttnShapes, *, causal: bool,
                   window: int | None, kw: dict) -> ExecutionPlan:
        """Bind ``name`` as one flat ring over the context's transport."""
        desc = get_strategy(name)
        P_sp = self.sp_degree
        why = ineligible_reason(desc, Hq=shapes.Hq, Hkv=shapes.Hkv, P=P_sp, layout=self.layout,
                                window=window)
        if why is not None:
            raise ValueError(f"strategy {name!r} cannot run this config: {why}")
        extras = self._strategy_kwargs(desc)
        ring, fn = self.ring, desc.fn

        def local_fn(q, k, v, qp, kp):
            return fn(q, k, v, qp, kp, ring=ring, **kw, **extras)

        cost = strategy_cost(
            desc, shapes.B, shapes.Sq, shapes.Hq, shapes.Hkv, shapes.D, P_sp,
            bytes_per_elem=shapes.dtype_bytes, bidir_links=self.bidir_links,
            S_kv=shapes.seq_kv, window=window, **extras,
        )
        compute_flops = attention_compute_flops(
            shapes.B, shapes.Sq, shapes.Hq, shapes.D, P_sp, S_kv=shapes.seq_kv,
            causal=causal, window=window if desc.supports_window else None,
        )
        return ExecutionPlan(strategy=name, local_fn=local_fn, ring=ring, sp_degree=P_sp,
                             cost=cost, compute_flops=compute_flops, pipelines=desc.pipelines)

    # -- serving plans -----------------------------------------------------

    def _serving_cost(self, name: str, shapes: AttnShapes | None,
                      table_pages: int | None = None) -> CommCost | None:
        """Price a registered serving schedule for these shapes (the
        ``comm_cost`` machinery training plans go through); ``table_pages``
        (block-table width) adds the paged cache's table term."""
        if shapes is None:
            return None
        return strategy_cost(
            get_strategy(name), shapes.B, shapes.Sq, shapes.Hq, shapes.Hkv, shapes.D,
            self.sp_degree, bytes_per_elem=shapes.dtype_bytes, bidir_links=self.bidir_links,
            S_kv=shapes.seq_kv, table_pages=table_pages,
        )

    def _serving_ring(self):
        if not self.active:
            raise ValueError("serving plans require sp_degree > 1")
        return self.ring

    def plan_decode(self, *, window: int | None = None, scale: float | None = None,
                    shapes: AttnShapes | None = None,
                    table_pages: int | None = None) -> ExecutionPlan:
        """Decode plan: a small replicated Q against the sequence-sharded
        cache, the registered ``"decode"`` schedule.  With ``shapes`` (``Sq``
        query tokens a step, ``Sk`` the cache capacity) the plan carries its
        modeled link bytes a step, ``B*Sq*Hq*(D+2)`` float32 scalars through
        a ring all-reduce, independent of the cache length; ``table_pages``
        adds the paged cache's block-table term.  The plan takes ``(q,
        k_cache, v_cache, k_pos, q_pos)``, the cache in the ring's layout."""
        key = ("decode", window, scale, shapes, table_pages)
        if key in self._serving_plans:
            return self._serving_plans[key]
        ring, fn = self._serving_ring(), get_strategy("decode").fn
        block_k = self.decode_block_k

        def local_fn(q, kc, vc, kp, qp):
            return fn(q, kc, vc, kp, q_pos=qp, ring=ring, causal=True, window=window,
                      scale=scale, impl=self.impl, block_k=block_k)

        plan = self._serving_plans[key] = ExecutionPlan(
            strategy="decode", local_fn=local_fn, ring=ring, sp_degree=self.sp_degree,
            cost=self._serving_cost("decode", shapes, table_pages), kind="decode",
            kernel={"path": "dense", "impl": self.impl, "block_k_decode": block_k},
        )
        return plan

    def plan_decode_paged(self, *, window: int | None = None, scale: float | None = None,
                          shapes: AttnShapes | None = None,
                          table_pages: int | None = None) -> ExecutionPlan:
        """Fused paged-decode plan: Q replicated, the page pool stays
        page-striped and no gathered dense view exists.  Each rank runs
        kernel C over its stripe (``core/decode.py``) and the partials merge
        in the same all-reduce as dense decode (the same wire bytes, so the
        ``"decode"`` cost row prices this plan too).  The plan takes ``(q,
        k_pool, v_pool, pos_pool, block_tables, q_pos, lengths)``: the whole
        pool on the virtual ring, the rank's stripe on a process group."""
        from repro_torch.core.decode import sp_paged_decode_attention

        key = ("decode_paged", window, scale, shapes, table_pages)
        if key in self._serving_plans:
            return self._serving_plans[key]
        ring, impl, block_k = self._serving_ring(), self.impl, self.decode_block_k

        def local_fn(q, k_pool, v_pool, pos_pool, bt, qp, lengths):
            return sp_paged_decode_attention(
                q, k_pool, v_pool, pos_pool, bt, qp, ring=ring, lengths=lengths,
                window=window, scale=scale, impl=impl, block_k=block_k,
            )

        plan = self._serving_plans[key] = ExecutionPlan(
            strategy="decode", local_fn=local_fn, ring=ring, sp_degree=self.sp_degree,
            cost=self._serving_cost("decode", shapes, table_pages), kind="decode",
            kernel={"path": "paged_fused", "impl": impl, "block_k_decode": block_k},
        )
        return plan

    def plan_prefill(self, *, window: int | None = None, scale: float | None = None,
                     shapes: AttnShapes | None = None, table_pages: int | None = None,
                     strategy: str | None = None) -> ExecutionPlan:
        """Chunked-prefill plan: a replicated prompt chunk against the
        resident sharded cache plus its own local block (cross-chunk
        causality through the Update() merge, ``core/decode.py``).

        ``strategy`` ``None`` or ``"prefill"`` binds the registered
        ``"prefill"`` schedule; with ``shapes`` (``Sq`` the chunk length,
        ``Sk`` the cache capacity) the plan carries the modeled link bytes a
        chunk (plus the block-table term with ``table_pages``).  The
        reference's prefill rings and its ``"auto"`` arbitration over them
        raise ``NotImplementedError`` naming their item.  The plan takes
        ``(q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, q_pos)``, the
        cache in the ring's layout."""
        if strategy == "auto":
            raise NotImplementedError(_PREFILL_RINGS)
        if strategy in UNPORTED:
            raise NotImplementedError(not_ported(strategy))
        if strategy is not None and strategy not in PREFILL_CANDIDATES:
            raise ValueError(
                f"plan_prefill strategy {strategy!r} not one of {PREFILL_CANDIDATES}"
            )
        key = ("prefill", window, scale, shapes, table_pages)
        if key in self._serving_plans:
            return self._serving_plans[key]
        ring, fn = self._serving_ring(), get_strategy("prefill").fn

        def local_fn(q, kn, vn, np_, kc, vc, kp, qp):
            return fn(q, kn, vn, np_, kc, vc, kp, q_pos=qp, ring=ring, window=window,
                      scale=scale, impl=self.impl, block_q=self.block_q, block_k=self.block_k)

        plan = self._serving_plans[key] = ExecutionPlan(
            strategy="prefill", local_fn=local_fn, ring=ring, sp_degree=self.sp_degree,
            cost=self._serving_cost("prefill", shapes, table_pages), kind="prefill",
        )
        return plan


def _check_ring_device(pctx: ParallelContext, x):
    ring = pctx.ring
    if ring.folded and x.device.type != ring.device.type:
        raise ValueError(f"the virtual ring runs on {ring.device.type}, got tensors on "
                         f"{x.device}; pass ParallelContext(device='cpu') to run it on the CPU")


def _sharded_positions(pctx: ParallelContext, k_pos, k_cache):
    """``k_pos`` of a sequence-sharded cache as ``(rows, S_loc)`` int32;
    refused when absent, since a shard's slots hold no default positions."""
    if k_pos is None:
        raise ValueError("k_pos is required with sp_degree > 1: the positions of a "
                         "sequence-sharded cache are global, not its local slot indices")
    return normalize_positions(k_pos, k_cache.shape[0], k_cache.shape[1], k_cache.device)


def sp_attention(q, k, v, q_pos, k_pos, *, pctx: ParallelContext, causal: bool = True,
                 window: int | None = None, scale: float | None = None):
    """Attention of the training path: ``q (B,Sq,Hq,D)``, ``k/v (B,Sk,Hkv,D)``
    with global positions ``q_pos``/``k_pos`` (``(B,S)`` or ``(S,)``, already
    layout-permuted).  Differentiable: kernel A forward, B1/B2 backward.

    With ``sp_degree > 1`` on the virtual ring the tensors are global; on a
    process group they are this rank's shard (its rows of the layout)."""
    from repro_torch.kernels.ops import flash_attention

    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    q_pos = normalize_positions(q_pos, B, Sq, q.device)
    k_pos = normalize_positions(k_pos, B, Sk, q.device)
    if not pctx.active:
        out, _ = flash_attention(
            q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal, window=window, scale=scale,
            impl=pctx.impl, block_q=pctx.block_q, block_k=pctx.block_k,
            block_q_bwd=pctx.block_q_bwd, block_k_bwd=pctx.block_k_bwd,
        )
        return out
    ring = pctx.ring
    _check_ring_device(pctx, q)
    shards = 1 if ring.folded else pctx.sp_degree  # a process group passes its shard
    shapes = AttnShapes(B=B, Sq=Sq * shards, Hq=Hq, Hkv=Hkv, D=D, Sk=Sk * shards,
                        dtype_bytes=q.element_size())
    plan = pctx.plan(shapes, causal=causal, window=window, scale=scale)
    return plan(q, k, v, q_pos, k_pos)


def sp_decode(q, k_cache, v_cache, k_pos, q_pos, *, pctx: ParallelContext,
              window: int | None = None, scale: float | None = None,
              table_pages: int | None = None):
    """Decode attention: ``q (B,Sq,Hq,D)`` with small Sq, replicated, against
    the cache ``(B,Skv,Hkv,D)``; ``k_pos (B,Skv)`` (``PAD_POS`` for unwritten
    slots), ``q_pos (B,Sq)``.  With ``sp_degree > 1`` the cache is
    sequence-sharded and ``k_pos`` required: rank-major ``(P*B, Skv/P, ...)``
    on the virtual ring, this rank's shard ``(B, Skv/P, ...)`` on a process
    group.  ``table_pages``: block-table width when the cache is a gathered
    page view (priced into the plan's cost)."""
    from repro_torch.kernels.ops import flash_attention

    B = q.shape[0]
    q_pos = normalize_positions(q_pos, B, q.shape[1], q.device)
    if not pctx.active:
        k_pos = normalize_positions(k_pos, B, k_cache.shape[1], q.device)
        out, _ = flash_attention(
            q, k_cache, v_cache, q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
            scale=scale, impl=pctx.impl, block_k=pctx.block_k,
        )
        return out
    _check_ring_device(pctx, q)
    k_pos = _sharded_positions(pctx, k_pos, k_cache)
    shapes = AttnShapes(B=B, Sq=q.shape[1], Hq=q.shape[2], Hkv=k_cache.shape[2], D=q.shape[3],
                        Sk=k_cache.shape[1] * pctx.sp_degree, dtype_bytes=q.element_size())
    plan = pctx.plan_decode(window=window, scale=scale, shapes=shapes, table_pages=table_pages)
    return plan(q, k_cache, v_cache, k_pos, q_pos)


def sp_decode_paged(q, k_pool, v_pool, pos_pool, block_tables, q_pos, lengths, *,
                    pctx: ParallelContext, window: int | None = None,
                    scale: float | None = None, table_pages: int | None = None):
    """Fused paged decode: no materialized KV gather on the kernel path.

    ``q (B,1,Hq,D)``, ``q_pos (B,1)``, ``block_tables (B,W)`` (global page
    ids, ``n_pages`` for unmapped entries) and ``lengths (B,)`` replicated;
    the pools ``(n_pages,ps,Hkv,D)`` / ``pos_pool (n_pages,ps)`` whole on
    one device or the virtual ring, this rank's stripe of ``n_pages / P``
    pages on a process group."""
    from repro_torch.core.decode import sp_paged_decode_attention

    if not pctx.active:
        return sp_paged_decode_attention(
            q, k_pool, v_pool, pos_pool, block_tables, q_pos, lengths=lengths, window=window,
            scale=scale, impl=pctx.impl, block_k=pctx.decode_block_k,
        )
    _check_ring_device(pctx, q)
    pool_pages = k_pool.shape[0] * (1 if pctx.ring.folded else pctx.sp_degree)
    shapes = AttnShapes(B=q.shape[0], Sq=q.shape[1], Hq=q.shape[2], Hkv=k_pool.shape[2],
                        D=q.shape[3], Sk=pool_pages * k_pool.shape[1],
                        dtype_bytes=q.element_size())
    plan = pctx.plan_decode_paged(window=window, scale=scale, shapes=shapes,
                                  table_pages=table_pages)
    return plan(q, k_pool, v_pool, pos_pool, block_tables, q_pos, lengths)


def sp_prefill(q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, q_pos, *,
               pctx: ParallelContext, window: int | None = None,
               scale: float | None = None, table_pages: int | None = None):
    """Chunked-prefill attention: the chunk ``q``/``k_new``/``v_new
    (B,C,H,D)`` with ``new_pos``/``q_pos (B,C)`` (replicated) against the
    resident cache ``(B,Skv,Hkv,D)`` / ``k_pos (B,Skv)`` holding every
    *previous* chunk (sharded as in :func:`sp_decode`), merged with the
    chunk's own causal block.  The caller writes the chunk's K/V
    afterwards."""
    from repro_torch.core.decode import sp_prefill_chunk_attention

    B, C = q.shape[0], q.shape[1]
    q_pos = normalize_positions(q_pos, B, C, q.device)
    new_pos = normalize_positions(new_pos, B, C, q.device)
    if not pctx.active:
        k_pos = normalize_positions(k_pos, B, k_cache.shape[1], q.device)
        return sp_prefill_chunk_attention(
            q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, q_pos=q_pos, window=window,
            scale=scale, impl=pctx.impl, block_q=pctx.block_q, block_k=pctx.block_k,
        )
    _check_ring_device(pctx, q)
    k_pos = _sharded_positions(pctx, k_pos, k_cache)
    shapes = AttnShapes(B=B, Sq=C, Hq=q.shape[2], Hkv=k_cache.shape[2], D=q.shape[3],
                        Sk=k_cache.shape[1] * pctx.sp_degree, dtype_bytes=q.element_size())
    plan = pctx.plan_prefill(window=window, scale=scale, shapes=shapes, table_pages=table_pages)
    return plan(q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, q_pos)

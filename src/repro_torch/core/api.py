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
other strategies, its topology-aware and multi-pod (hybrid, hierarchical)
plans, and the multi-card serving paths raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.strategies import (
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

_SERVING_SLICE = ("multi-card serving (sp_decode, sp_decode_paged and sp_prefill with "
                  "sp_degree > 1) is not ported yet: it comes with the SP branches of "
                  "core/decode.py (ROADMAP queue 1 item 5)")
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
    """A validated, resolved SP attention: what ``sp_attention`` runs.

    ``local_fn`` is the per-rank callable (strategy schedule and ring
    bound); ``cost`` the strategy's modeled per-device link bytes for one
    forward pass of the layer, ``compute_flops`` its per-device attention
    dot FLOPs (the two halves of the ``max(compute, link)`` step model).
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

    def __call__(self, q, k, v, q_pos, k_pos):
        """Global tensors on a virtual ring, this rank's shard on a process
        group; the result in the same form."""
        if not self.ring.folded:
            return self.local_fn(q, k, v, q_pos, k_pos)
        from repro_torch.core.collectives import fold_ranks, unfold_ranks

        P = self.sp_degree
        out = self.local_fn(*(fold_ranks(x, P) for x in (q, k, v, q_pos, k_pos)))
        return unfold_ranks(out, P)


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


def _single_device(pctx: ParallelContext):
    if pctx.active:
        raise NotImplementedError(_SERVING_SLICE)


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
    if ring.folded and q.device.type != ring.device.type:
        raise ValueError(f"the virtual ring runs on {ring.device.type}, got tensors on "
                         f"{q.device}; pass ParallelContext(device='cpu') to run it on the CPU")
    shards = 1 if ring.folded else pctx.sp_degree  # a process group passes its shard
    shapes = AttnShapes(B=B, Sq=Sq * shards, Hq=Hq, Hkv=Hkv, D=D, Sk=Sk * shards,
                        dtype_bytes=q.element_size())
    plan = pctx.plan(shapes, causal=causal, window=window, scale=scale)
    return plan(q, k, v, q_pos, k_pos)


def sp_decode(q, k_cache, v_cache, k_pos, q_pos, *, pctx: ParallelContext,
              window: int | None = None, scale: float | None = None):
    """Decode attention: ``q (B,Sq,Hq,D)`` with small Sq against the cache
    ``(B,Skv,Hkv,D)``; ``k_pos (B,Skv)`` (``PAD_POS`` for unwritten slots),
    ``q_pos (B,Sq)``."""
    from repro_torch.kernels.ops import flash_attention

    _single_device(pctx)
    B = q.shape[0]
    q_pos = normalize_positions(q_pos, B, q.shape[1], q.device)
    k_pos = normalize_positions(k_pos, B, k_cache.shape[1], q.device)
    out, _ = flash_attention(
        q, k_cache, v_cache, q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
        scale=scale, impl=pctx.impl, block_k=pctx.block_k,
    )
    return out


def sp_decode_paged(q, k_pool, v_pool, pos_pool, block_tables, q_pos, lengths, *,
                    pctx: ParallelContext, window: int | None = None,
                    scale: float | None = None):
    """Fused paged decode: no materialized KV gather on the kernel path."""
    from repro_torch.core.decode import sp_paged_decode_attention

    _single_device(pctx)
    return sp_paged_decode_attention(
        q, k_pool, v_pool, pos_pool, block_tables, q_pos, lengths=lengths, window=window,
        scale=scale, impl=pctx.impl, block_k=pctx.decode_block_k,
    )


def sp_prefill(q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, q_pos, *,
               pctx: ParallelContext, window: int | None = None,
               scale: float | None = None):
    """Chunked-prefill attention: the chunk ``(B,C,H,D)`` against the
    resident cache holding every *previous* chunk, merged with the chunk's
    own causal block.  The caller writes the chunk's K/V afterwards."""
    from repro_torch.core.decode import sp_prefill_chunk_attention

    _single_device(pctx)
    B, C = q.shape[0], q.shape[1]
    q_pos = normalize_positions(q_pos, B, C, q.device)
    new_pos = normalize_positions(new_pos, B, C, q.device)
    k_pos = normalize_positions(k_pos, B, k_cache.shape[1], q.device)
    return sp_prefill_chunk_attention(
        q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, q_pos=q_pos, window=window,
        scale=scale, impl=pctx.impl, block_q=pctx.block_q, block_k=pctx.block_k,
    )

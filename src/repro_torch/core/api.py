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

Built-in strategies: ``"tokenring"`` (the paper's method, split-Q
bidirectional), ``"tokenring_faithful"`` (Algorithm 1), ``"ring"`` /
``"ring_bidir"`` (baselines), ``"ulysses"`` (all-to-all head parallelism,
head-count bound), ``"window"`` (halo-exchange sliding-window attention,
what a windowed layer resolves to) and ``"auto"``, the cost models'
argmin over all of them.

With ``pods > 1`` the context factors its ring row-major as ``(pod,
inner)``, the reference's two SP mesh axes, and ``plan`` builds the paper's
Case-Study-III hybrid: the inter-pod KV ring outside, the chosen (or
``inner_strategy``) intra-pod strategy inside (``core/hybrid.py``).
``plan(topology=...)`` arbitrates the flat ring against the hierarchical
``"tokenring2d"`` schedule (``core/hier2d.py``) on a physical link graph
(``core/topology.py``).

Serving (:func:`sp_decode`, :func:`sp_decode_paged`, :func:`sp_prefill`)
keeps the KV cache sequence-sharded and replicates the small query side:
:meth:`ParallelContext.plan_decode` / :meth:`~ParallelContext.plan_prefill`
bind the registered ``"decode"`` / ``"prefill"`` schedules of
``core/decode.py``, whose partials merge in an lse-weighted all-reduce.
``plan_prefill(strategy="auto")`` arbitrates that resident chunk path
against the two prefill rings (``core/prefill_rings.py``) from the KV:Q
byte ratio and the prefix cache's hit rate; a ring winner is an
attention-style plan over sequence-sharded q/k/v.
The cache comes in the ring's layout: rank-major ``(P*B, Skv/P, ...)`` on
the virtual ring (rank ``r``'s contiguous shard in rows ``[r*B, (r+1)*B)``,
as the serve state keeps it and ``core.collectives.fold_ranks`` makes it
from a global tensor), this rank's shard on a process group; the paged pool
is whole on the virtual ring and the rank's stripe of pages on a process
group.  The query side and the result are replicated.  The plans are built
once per shape and window and kept on the context.

With ``data_degree > 1`` (or a ``mesh``, ``launch/mesh.py``) the context
adds the reference's data axis: ``plan`` prices one data rank's batch, the
trainer stores parameters and moments by the FSDP rules
(``repro_torch.sharding``) over ``storage``, the mesh's collectives, and
``data`` is the data axis's view.  On the virtual mesh the model sees the
global batch and the ring folds its ranks in front of it; on a process
group of the whole mesh (``ring=`` its group) the context factors it into
the SP ring (the ranks that share a data index) and the data view (the
ranks that share a model index), ``core/collectives.py`` "The data axis".

The attention-free families run :func:`sp_scan`, a diagonal linear
recurrence whose sequence :meth:`ParallelContext.plan_scan` shards
contiguously over the flat ring whatever the layout
(``core/recurrence.py``), with the same global-in/global-out convention
as :func:`sp_attention`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

from repro_torch.core.strategies import (
    KV_RESIDENT_MARGIN,
    CommCost,
    SPStrategy,
    _decision_travel_dtype,
    attention_compute_flops,
    available_strategies,
    ceil_div,
    get_strategy,
    ineligible_reason,
    resolve_strategy,
    strategy_cost,
)
from repro_torch.kernels.ref import normalize_positions

__all__ = ["ParallelContext", "ExecutionPlan", "AttnShapes", "PREFILL_CANDIDATES",
           "choose_strategy", "sp_attention", "sp_decode", "sp_decode_paged", "sp_prefill", "sp_scan"]

# The prefill arbitration pool (``ParallelContext.choose_prefill_strategy``):
# the resident all-reduce chunk path plus the two prefill rings of
# ``core/prefill_rings.py`` — opposite bets on what moves over the wire,
# decided per request by the KV:Q byte ratio after prefix-cache hits are
# subtracted from the query side.
PREFILL_CANDIDATES = ("prefill", "passkv_ring", "passq_ring")
_PREFILL_RINGS = ("passkv_ring", "passq_ring")


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
    ``sp_attention`` runs), serving step (``"decode"``, ``"prefill"``) or
    linear recurrence (``"scan"``, what ``sp_scan`` runs; its sequence on
    ``seq_axis``).

    ``local_fn`` is the per-rank callable (strategy schedule and ring
    bound); ``cost`` the strategy's modeled per-device link bytes for one
    forward pass of the layer (one step of a serving plan),
    ``compute_flops`` its per-device attention dot FLOPs (the two halves of
    the ``max(compute, link)`` step model).  ``inner`` names the intra-pod
    strategy when the hybrid wraps it; ``topology_decision`` records the
    scored candidates and the winner of ``plan(topology=...)``; ``kernel``
    records a serving plan's kernel path.
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
    inner: str | None = None
    topology_decision: dict | None = None
    kernel: dict | None = None
    seq_axis: int = 1

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
        """An attention plan (and a prefill ring's, and a scan) takes global
        tensors on a virtual ring and this rank's shard on a process group,
        and returns the result in the same form.  A resident serving plan
        takes its cache in the ring's layout (rank-major on the virtual
        ring) and a replicated query side, and returns the replicated
        result."""
        from repro_torch.core.collectives import fold_ranks, unfold_ranks

        sharded = self.kind in ("attention", "scan") or self.strategy in _PREFILL_RINGS
        if not sharded or not self.ring.folded:
            return self.local_fn(*args)
        P, ax = self.sp_degree, self.seq_axis
        out = self.local_fn(*(fold_ranks(x.movedim(ax, 1), P).movedim(1, ax) for x in args))
        return unfold_ranks(out.movedim(ax, 1), P).movedim(1, ax)


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
    # Pods of the ring (the reference's pod mesh axis): the ranks factor
    # row-major as (pods, sp_degree // pods), and with pods > 1 attention
    # plans are the multi-pod hybrid (inter-pod KV ring x intra-pod inner).
    pods: int = 1
    strategy: str = "tokenring"  # a registered SP strategy or "auto"
    inner_strategy: str | None = None  # the hybrid's inner; defaults to `strategy`
    layout: str = "zigzag"  # zigzag | contig (layout of the seq dim in data)
    # Wire format of TokenRing's travelling (out, lse) accumulator:
    # "bfloat16" halves its link bytes at about 1e-3 merge rounding (lse
    # always stays float32).
    travel_dtype: str = "float32"
    # Whether the links carry both ring directions at full rate (NVLink).
    # False makes the planner score total bytes, not max-direction.
    bidir_links: bool = True
    # Post every send of a step before its computes (core/schedule.py).
    # False runs each send to its end before the step's computes (nothing
    # overlaps); values and gradients are bitwise equal either way.
    overlap: bool = True
    # The ring transport: None is the virtual ring of sp_degree ranks on
    # `device`; a torch.distributed process group (or a transport of
    # core.collectives) runs one rank per process.  With a mesh, a process
    # group holds every rank of the mesh and the context factors it.
    ring: Any = None
    # Data parallelism: the batch divides over `data_degree` data ranks
    # (the reference's data_axis, as a size; 1 when the mesh's data axis is
    # dropped because the batch does not divide).  `mesh`
    # (launch.mesh.Mesh: ("data", "model") or ("pod", "data", "model"))
    # is made from the degrees when data_degree > 1 and none is given; with
    # a mesh the trainer stores parameters and moments by the FSDP rules
    # (repro_torch.sharding).
    data_degree: int = 1
    mesh: Any = None
    # The mesh's FSDP collectives (core.collectives' mesh transports): made
    # here from the mesh and `ring`; `dataclasses.replace` passes it on.
    storage: Any = None

    def __post_init__(self):
        from repro_torch.core.collectives import (
            ProcessGroupMeshComm,
            ProcessGroupRing,
            VirtualMeshComm,
            VirtualRing,
        )

        if self.pods < 1 or self.sp_degree % self.pods:
            raise ValueError(f"pods={self.pods} does not divide sp_degree={self.sp_degree}")
        mesh = self.mesh
        if mesh is None and self.data_degree > 1:
            from repro_torch.launch.mesh import data_mesh

            mesh = data_mesh(self.data_degree, self.sp_degree // self.pods, self.pods)
        if mesh is not None:
            shape = mesh.shape
            if shape.get("pod", 1) != self.pods or shape.get("pod", 1) * shape["model"] != \
                    self.sp_degree:
                raise ValueError(f"mesh {shape} does not hold sp_degree={self.sp_degree} in "
                                 f"pods={self.pods}")
            if self.data_degree not in (1, shape["data"]):
                raise ValueError(f"data_degree={self.data_degree} on a data axis of "
                                 f"{shape['data']}")
        object.__setattr__(self, "mesh", mesh)
        ring, storage = self.ring, self.storage
        if mesh is not None and storage is None:
            if ring is not None and not hasattr(ring, "post"):
                # one process a rank of the mesh: the SP ring and the data
                # view are subgroups of it (core/collectives.py, "The data
                # axis")
                storage = ProcessGroupMeshComm(mesh, ring)
                sp_axes = ("pod", "model") if self.pods > 1 else ("model",)
                ring = storage.view(sp_axes, "link")
                if ring is not None and self.pods > 1:
                    ring._splits[self.pods] = (storage.view(("pod",), "inter"),
                                               storage.view(("model",), "intra"))
            elif ring is None or ring.folded:
                if ring is None and self.sp_degree > 1:
                    ring = VirtualRing(self.sp_degree, self.device, groups=self.data_degree)
                storage = VirtualMeshComm(mesh, ring.ledger if ring is not None else None,
                                          data_groups=self.data_degree)
            else:
                raise ValueError("a mesh over processes takes their torch.distributed group "
                                 "as ring=, not a ring transport")
        elif ring is None:
            if self.sp_degree > 1:
                ring = VirtualRing(self.sp_degree, self.device)
        elif not hasattr(ring, "post"):
            ring = ProcessGroupRing(ring)
        if ring is not None and ring.size != self.sp_degree:
            raise ValueError(f"the ring has {ring.size} ranks, sp_degree is {self.sp_degree}")
        object.__setattr__(self, "ring", ring)
        object.__setattr__(self, "storage", storage)
        # the data axis's view (None without a mesh): a ring of the data
        # ranks on the storage's ledger, class "data"
        data = None
        if storage is not None:
            data = (VirtualRing(mesh.shape["data"], self.device, link_class="data",
                                ledger=storage.ledger) if storage.folded
                    else storage.view(("data",), "data"))
        object.__setattr__(self, "data", data)
        # (pod ring, inner ring): the views of the two axes (a process group
        # makes their subgroups here, on every rank alike)
        object.__setattr__(self, "axis_rings", ring.split(self.pods) if self.pods > 1 else None)
        # serving and scan plans by (kind, window, scale, shapes,
        # table_pages) and (kind, ndim, axis): the serving steps and the
        # recurrent layers ask for the same few plans in every layer of
        # every step
        object.__setattr__(self, "_serving_plans", {})

    @property
    def active(self) -> bool:
        return self.sp_degree > 1

    @property
    def data_axis(self) -> str | None:
        """The batch's mesh axis (the reference's ``data_axis``): ``"data"``
        when the batch divides over it, else ``None``."""
        if self.mesh is None or self.data_degree != self.mesh.shape["data"]:
            return None
        return "data"

    def seq_spec(self):
        """The spec entry of the sequence dimension: the SP axes."""
        if self.mesh is None:
            return None
        return ("pod", "model") if "pod" in self.mesh.axis_names else "model"

    def _local(self, shapes: AttnShapes) -> AttnShapes:
        """Cost models are per rank: the batch dim shards over data."""
        return replace(shapes, B=max(1, shapes.B // self.data_degree))

    @property
    def decode_block_k(self) -> int:
        return self.block_k_decode if self.block_k_decode is not None else self.block_k

    # -- planning ----------------------------------------------------------

    def _strategy_kwargs(self, desc: SPStrategy) -> dict:
        """Extras declared by the descriptor, sourced from this context."""
        return {name: getattr(self, name) for name in desc.extra_kwargs if hasattr(self, name)}

    def _kernel_kw(self, causal: bool, window: int | None, scale: float | None) -> dict:
        return dict(causal=causal, window=window, scale=scale, impl=self.impl,
                    block_q=self.block_q, block_k=self.block_k, block_q_bwd=self.block_q_bwd,
                    block_k_bwd=self.block_k_bwd, overlap=self.overlap)

    def plan(self, shapes: AttnShapes, *, causal: bool = True, window: int | None = None,
             scale: float | None = None, topology=None) -> ExecutionPlan:
        """Validate the ring and layout and resolve the strategy for these
        shapes into an :class:`ExecutionPlan`.

        ``"auto"`` resolves by per-strategy ``comm_cost`` argmin; with
        ``pods > 1`` the plan is the Case-Study-III hybrid decomposition
        (inter-pod KV ring outside, the resolved strategy inside).

        ``topology`` (a :class:`repro_torch.core.topology.Topology`)
        arbitrates against the physical graph instead of a single abstract
        link: the flat resolved ring is priced at the slowest wire its
        Hamiltonian placement traverses, the hierarchical ``"tokenring2d"``
        schedule at its per-class ``CommCost.links`` split over the graph's
        per-class bandwidths, and the faster plan wins (``ExecutionPlan
        .topology_decision`` records the scores).
        """
        if not self.active:
            raise ValueError("planning requires sp_degree > 1")
        P_sp = self.sp_degree
        if shapes.Sq % P_sp or shapes.seq_kv % P_sp:
            raise ValueError(
                f"sequence length {shapes.Sq}/{shapes.seq_kv} not divisible "
                f"by SP degree {P_sp}"
            )
        shapes = self._local(shapes)
        kw = self._kernel_kw(causal, window, scale)
        if topology is not None:
            return self._plan_topology(topology, shapes, causal=causal, window=window, kw=kw)

        hybrid = self.pods > 1
        # Eligibility (and cost) for a hybrid plan is judged at the *inner*
        # ring size: the outer pod ring only circulates KV shards, so e.g.
        # Ulysses' head-divisibility limit applies to the intra-pod degree.
        P_elig = P_sp // self.pods if hybrid else P_sp
        resolve_kw = dict(
            B=shapes.B, S=shapes.Sq, Hq=shapes.Hq, Hkv=shapes.Hkv, D=shapes.D,
            bytes_per_elem=shapes.dtype_bytes, S_kv=shapes.seq_kv,
            bidir_links=self.bidir_links, layout=self.layout, window=window,
        )
        # Windowed layers: only window-capable strategies are meaningful —
        # circulating the whole sequence for a local window wastes the ring.
        name = self.strategy
        if window is not None and (name == "auto" or not get_strategy(name).supports_window):
            name = resolve_strategy("auto", P=P_sp, **resolve_kw)
        # A hybrid "auto" arbitrates the *inner* schedule: restrict the pool
        # to hybrid-capable strategies up front so the cost argmin is never
        # silently discarded by a post-hoc hybrid_inner_ok fallback.
        candidates = None
        if hybrid and name == "auto":
            candidates = tuple(n for n in available_strategies()
                               if get_strategy(n).hybrid_inner_ok)
        name = resolve_strategy(name, P=P_elig, candidates=candidates, **resolve_kw)
        desc = get_strategy(name)
        if desc.supports_window:
            hybrid = False  # window strategies flatten the two axes themselves
        if not hybrid:
            return self._flat_plan(name, shapes, causal=causal, window=window, kw=kw)

        # Case Study III: inter-pod KV ring outside, `inner` inside.
        from repro_torch.core.hybrid import hybrid_sp

        n_pods, P_inner = self.pods, P_sp // self.pods
        inner = self.inner_strategy or name
        inner_desc = get_strategy(inner)
        if not inner_desc.hybrid_inner_ok:
            # Same validation depth whether the intent was expressed via
            # strategy= or inner_strategy= — never silently run a
            # different schedule than the one configured.
            raise ValueError(
                f"strategy {inner!r} cannot run inside the multi-pod "
                f"hybrid; pick a hybrid-capable inner (or strategy="
                f"'auto') for multi-axis meshes"
            )
        why = ineligible_reason(inner_desc, Hq=shapes.Hq, Hkv=shapes.Hkv, P=P_inner,
                                layout=self.layout, window=window)
        if why is not None:
            raise ValueError(
                f"hybrid inner strategy {inner!r} cannot run this config "
                f"(intra-pod degree {P_inner}): {why}"
            )
        inner_extras = self._strategy_kwargs(inner_desc)
        pod_ring, inner_ring = self.axis_rings

        def local_fn(q, k, v, qp, kp):
            return hybrid_sp(q, k, v, qp, kp, pod_ring=pod_ring, ring=inner_ring, inner=inner,
                             **kw, **inner_extras)

        cost = _hybrid_cost(inner_desc, shapes, n_pods=n_pods, P_inner=P_inner,
                            bidir_links=self.bidir_links, extras=inner_extras)
        compute_flops = attention_compute_flops(
            shapes.B, shapes.Sq, shapes.Hq, shapes.D, P_sp, S_kv=shapes.seq_kv, causal=causal,
        )
        return ExecutionPlan(
            strategy=name, inner=inner, local_fn=local_fn, ring=self.ring, sp_degree=P_sp,
            cost=cost, compute_flops=compute_flops,
            # The outer pod ring always prefetches, but the inner pass
            # dominates the byte count — claim overlap only when the inner
            # schedule can deliver it (a ulysses inner cannot).
            pipelines=inner_desc.pipelines,
        )

    def _flat_plan(self, name: str, shapes: AttnShapes, *, causal: bool,
                   window: int | None, kw: dict,
                   topo_decision: dict | None = None) -> ExecutionPlan:
        """Bind ``name`` as one flat ring over all the context's ranks."""
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
                             cost=cost, compute_flops=compute_flops, pipelines=desc.pipelines,
                             topology_decision=topo_decision)

    def _plan_topology(self, topo, shapes: AttnShapes, *, causal: bool, window: int | None,
                       kw: dict) -> ExecutionPlan:
        """Arbitrate flat-vs-hierarchical against a physical topology graph.

        The flat candidate is priced at the slowest wire its Hamiltonian
        ``"ring"`` placement traverses (every hop is one physical wire, so
        the bottleneck link bounds every step); the ``"tokenring2d"``
        candidate at its declared per-class split (``CommCost.links``) over
        the graph's per-class bandwidths.
        """
        P_sp = self.sp_degree
        if topo.n_devices != P_sp:
            raise ValueError(
                f"topology {topo.name!r} has {topo.n_devices} devices but "
                f"the mesh's SP degree is {P_sp}"
            )
        resolve_kw = dict(
            B=shapes.B, S=shapes.Sq, Hq=shapes.Hq, Hkv=shapes.Hkv, D=shapes.D,
            bytes_per_elem=shapes.dtype_bytes, S_kv=shapes.seq_kv,
            bidir_links=self.bidir_links, layout=self.layout, window=window,
        )
        half_cls = topo.half_duplex_classes()
        # An explicit non-auto pin bypasses arbitration (never silently run
        # a different schedule than the one configured); "auto" resolves the
        # flat candidate by the usual registry argmin first.
        if self.strategy not in ("auto", "tokenring2d"):
            flat = self.strategy
        else:
            flat = resolve_strategy("auto", P=P_sp, **resolve_kw)
        flat_desc = get_strategy(flat)
        flat_cost = strategy_cost(
            flat_desc, shapes.B, shapes.Sq, shapes.Hq, shapes.Hkv, shapes.D, P_sp,
            bytes_per_elem=shapes.dtype_bytes, bidir_links=self.bidir_links,
            S_kv=shapes.seq_kv, window=window, **self._strategy_kwargs(flat_desc),
        )
        t_flat = flat_cost.time_s(
            {"link": topo.bottleneck_bw()}, bidir_links=self.bidir_links,
            half_duplex=frozenset({"link"}) if half_cls else frozenset(),
        )
        decision = {
            "topology": topo.name,
            "bottleneck_bw": topo.bottleneck_bw(),
            "class_bandwidths": dict(topo.class_bandwidths()),
            "candidates": {flat: t_flat},
        }
        hier_desc = get_strategy("tokenring2d")
        S_loc = shapes.Sq // P_sp
        eligible_2d = (
            topo.n_pods > 1
            and P_sp % topo.n_pods == 0
            and self.pods == topo.n_pods
            and S_loc % 2 == 0
            and window is None
        )
        if self.strategy == "tokenring2d" and not eligible_2d:
            raise ValueError(
                f"strategy 'tokenring2d' cannot run on {topo.name!r} with "
                f"pods={self.pods}: needs a podded graph whose pod count equals "
                f"the context's pods, an even per-rank query split, and no window"
            )
        if eligible_2d:
            hier_cost = strategy_cost(
                hier_desc, shapes.B, shapes.Sq, shapes.Hq, shapes.Hkv, shapes.D, P_sp,
                bytes_per_elem=shapes.dtype_bytes, bidir_links=self.bidir_links,
                S_kv=shapes.seq_kv, window=window, n_pods=topo.n_pods,
                **self._strategy_kwargs(hier_desc),
            )
            t_hier = hier_cost.time_s(dict(topo.class_bandwidths()),
                                      bidir_links=self.bidir_links, half_duplex=half_cls)
            decision["candidates"]["tokenring2d"] = t_hier
            # an explicit flat pin is never overridden — only "auto" (or an
            # explicit 2D pin) binds the hierarchical schedule
            if self.strategy == "tokenring2d" or (self.strategy == "auto" and t_hier < t_flat):
                decision["chosen"] = "tokenring2d"
                return self._hier2d_plan(shapes, causal=causal, kw=kw, cost=hier_cost,
                                         decision=decision)
        decision["chosen"] = flat
        return self._flat_plan(flat, shapes, causal=causal, window=window, kw=kw,
                               topo_decision=decision)

    def _hier2d_plan(self, shapes: AttnShapes, *, causal: bool, kw: dict, cost: CommCost,
                     decision: dict) -> ExecutionPlan:
        """Bind the hierarchical 2D TokenRing over the (pod, inner) views."""
        desc = get_strategy("tokenring2d")
        extras = self._strategy_kwargs(desc)
        rings, fn = self.axis_rings, desc.fn

        def local_fn(q, k, v, qp, kp):
            return fn(q, k, v, qp, kp, ring=rings, **kw, **extras)

        compute_flops = attention_compute_flops(
            shapes.B, shapes.Sq, shapes.Hq, shapes.D, self.sp_degree, S_kv=shapes.seq_kv,
            causal=causal,
        )
        return ExecutionPlan(
            strategy="tokenring2d", local_fn=local_fn, ring=self.ring,
            sp_degree=self.sp_degree, cost=cost, compute_flops=compute_flops,
            pipelines=desc.pipelines, topology_decision=decision,
        )

    # -- serving plans -----------------------------------------------------

    def _serving_cost(self, name: str, shapes: AttnShapes | None,
                      table_pages: int | None = None) -> CommCost | None:
        """Price a registered serving schedule for these shapes (the
        ``comm_cost`` machinery training plans go through); ``table_pages``
        (block-table width) adds the paged cache's table term."""
        if shapes is None:
            return None
        shapes = self._local(shapes)
        return strategy_cost(
            get_strategy(name), shapes.B, shapes.Sq, shapes.Hq, shapes.Hkv, shapes.D,
            self.sp_degree, bytes_per_elem=shapes.dtype_bytes, bidir_links=self.bidir_links,
            S_kv=shapes.seq_kv, table_pages=table_pages,
        )

    def _serving_ring(self):
        if not self.active:
            raise ValueError("serving plans require sp_degree > 1")
        return self.ring

    def plan_decode(self, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None, shapes: AttnShapes | None = None,
                    table_pages: int | None = None) -> ExecutionPlan:
        """Decode plan: a small replicated Q against the sequence-sharded
        cache, the registered ``"decode"`` schedule.  With ``shapes`` (``Sq``
        query tokens a step, ``Sk`` the cache capacity) the plan carries its
        modeled link bytes a step, ``B*Sq*Hq*(D+2)`` float32 scalars through
        a ring all-reduce, independent of the cache length; ``table_pages``
        adds the paged cache's block-table term.  ``causal=False`` is the
        cross-attention read of a resident encoder.  The plan takes ``(q,
        k_cache, v_cache, k_pos, q_pos)``, the cache in the ring's layout."""
        key = ("decode", window, scale, shapes, table_pages, causal)
        if key in self._serving_plans:
            return self._serving_plans[key]
        ring, fn = self._serving_ring(), get_strategy("decode").fn
        block_k = self.decode_block_k

        def local_fn(q, kc, vc, kp, qp):
            return fn(q, kc, vc, kp, q_pos=qp, ring=ring, causal=causal, window=window,
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

    def effective_prefill_shapes(self, shapes: AttnShapes, *,
                                 prefix_hit_rate: float = 0.0) -> AttnShapes:
        """Shapes the prefill arbitration actually prices: the query side
        shrinks to the prefix-cache *miss suffix* (hit pages are already
        resident — only the suffix needs query work), rounded up to an
        SP-degree multiple so a ring schedule could run it; the KV side stays
        the full context (resident prefix KV still participates in
        attention)."""
        if not 0.0 <= prefix_hit_rate <= 1.0:
            raise ValueError(f"prefix_hit_rate {prefix_hit_rate} not in [0, 1]")
        P_sp = self.sp_degree
        miss = shapes.Sq - int(shapes.Sq * prefix_hit_rate)
        Sq_eff = max(P_sp, ceil_div(miss, P_sp) * P_sp)
        return replace(shapes, Sq=Sq_eff, Sk=shapes.seq_kv)

    def choose_prefill_strategy(self, shapes: AttnShapes, *, prefix_hit_rate: float = 0.0,
                                table_pages: int | None = None) -> str:
        """Arbitrate the prefill schedule over :data:`PREFILL_CANDIDATES`
        from the KV:Q byte ratio and the measured prefix-cache hit rate.

        ``shapes.Sq`` is the request's query (prompt) length, ``shapes.Sk``
        the full KV context it attends to.  The candidates' ``comm_cost``
        models are evaluated at the miss-suffix query length
        (:meth:`effective_prefill_shapes`): pass-KV scales with the *KV*
        side, pass-Q and the resident all-reduce with the *query* side.
        Argmin over max-direction bytes (total without bidirectional links)
        with the same KV-residency margin the training planner applies.
        """
        eff = self.effective_prefill_shapes(shapes, prefix_hit_rate=prefix_hit_rate)
        extras = {"travel_dtype": _decision_travel_dtype(eff.dtype_bytes),
                  "table_pages": table_pages}
        scored = []
        for name in PREFILL_CANDIDATES:
            desc = get_strategy(name)
            cost = strategy_cost(
                desc, eff.B, eff.Sq, eff.Hq, eff.Hkv, eff.D, self.sp_degree,
                bytes_per_elem=eff.dtype_bytes, bidir_links=self.bidir_links,
                S_kv=eff.seq_kv, **extras,
            )
            scored.append((cost.max_direction if self.bidir_links else cost.total, desc))
        scored.sort(key=lambda t: (t[0], t[1].name))
        best_score = scored[0][0]
        for score, desc in scored:
            if desc.kv_resident and score <= KV_RESIDENT_MARGIN * best_score:
                return desc.name
        return scored[0][1].name

    def plan_prefill(self, *, window: int | None = None, scale: float | None = None,
                     shapes: AttnShapes | None = None, table_pages: int | None = None,
                     strategy: str | None = None,
                     prefix_hit_rate: float = 0.0) -> ExecutionPlan:
        """Chunked-prefill plan: a replicated prompt chunk against the
        resident sharded cache plus its own local block (cross-chunk
        causality through the Update() merge, ``core/decode.py``).

        ``strategy`` ``None`` or ``"prefill"`` binds the registered
        ``"prefill"`` schedule; with ``shapes`` (``Sq`` the chunk length,
        ``Sk`` the cache capacity) the plan carries the modeled link bytes a
        chunk (plus the block-table term with ``table_pages``).  The plan
        takes ``(q, k_new, v_new, new_pos, k_cache, v_cache, k_pos, q_pos)``,
        the cache in the ring's layout.

        ``strategy="auto"`` arbitrates per request over
        :data:`PREFILL_CANDIDATES` via :meth:`choose_prefill_strategy`
        (requires ``shapes``; ``prefix_hit_rate`` is the engine's measured
        prefix-cache hit rate).  A ring winner returns an *attention-style*
        plan — q/k/v sequence-sharded (global tensors on the virtual ring,
        this rank's shard on a process group), causal — over the miss-suffix
        shapes; the resident winner returns the chunk plan.  An explicit ring
        name binds that ring unconditionally.
        """
        if strategy is not None:
            if strategy == "auto":
                if shapes is None:
                    raise ValueError(
                        "plan_prefill(strategy='auto') needs shapes= to "
                        "arbitrate the KV:Q byte ratio"
                    )
                strategy = self.choose_prefill_strategy(
                    shapes, prefix_hit_rate=prefix_hit_rate, table_pages=table_pages)
            elif strategy not in PREFILL_CANDIDATES:
                raise ValueError(
                    f"plan_prefill strategy {strategy!r} not one of {PREFILL_CANDIDATES}"
                )
            if strategy != "prefill":
                return self._plan_prefill_ring(strategy, shapes, window=window, scale=scale,
                                               prefix_hit_rate=prefix_hit_rate)
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

    def _plan_prefill_ring(self, name: str, shapes: AttnShapes | None, *,
                           window: int | None, scale: float | None,
                           prefix_hit_rate: float = 0.0) -> ExecutionPlan:
        """Bind a prefill *ring* (``passkv_ring`` / ``passq_ring``) as an
        attention-style plan over the miss-suffix shapes: q/k/v enter
        sequence-sharded (unlike the resident-chunk path's replicated
        chunk), the ring circulates its chosen side, causal."""
        ring = self._serving_ring()
        desc = get_strategy(name)
        P_sp = self.sp_degree
        extras = self._strategy_kwargs(desc)
        kw = self._kernel_kw(True, window, scale)
        fn = desc.fn

        def local_fn(q, k, v, qp, kp):
            return fn(q, k, v, qp, kp, ring=ring, **kw, **extras)

        cost = compute_flops = None
        if shapes is not None:
            eff = self.effective_prefill_shapes(shapes, prefix_hit_rate=prefix_hit_rate)
            cost = strategy_cost(
                desc, eff.B, eff.Sq, eff.Hq, eff.Hkv, eff.D, P_sp,
                bytes_per_elem=eff.dtype_bytes, bidir_links=self.bidir_links,
                S_kv=eff.seq_kv, window=window, **extras,
            )
            compute_flops = attention_compute_flops(eff.B, eff.Sq, eff.Hq, eff.D, P_sp,
                                                    S_kv=eff.seq_kv, causal=True)
        return ExecutionPlan(strategy=name, local_fn=local_fn, ring=ring, sp_degree=P_sp,
                             cost=cost, compute_flops=compute_flops, pipelines=desc.pipelines,
                             kind="prefill")

    # -- recurrences ---------------------------------------------------------

    def plan_scan(self, *, ndim: int, axis: int = 1) -> ExecutionPlan:
        """Sequence-parallel linear-recurrence plan: the sequence on
        ``axis`` (batch on dim 0) sharded **contiguously** over the flat
        ring whatever ``layout`` says, since a recurrence runs in time
        order (``core/recurrence.py``).  The plan takes ``(a, b)`` and
        returns ``h``: global tensors on the virtual ring, this rank's
        shard on a process group."""
        from repro_torch.core.recurrence import chunked_linear_recurrence

        if not self.active:
            raise ValueError("planning requires sp_degree > 1")
        if not 1 <= axis < ndim:
            raise ValueError(f"scan axis {axis} must be a non-batch dim of a {ndim}-d input")
        key = ("scan", ndim, axis)
        if key in self._serving_plans:
            return self._serving_plans[key]
        ring = self.ring

        def local_fn(a, b):
            return chunked_linear_recurrence(a, b, ring=ring, axis=axis)

        plan = self._serving_plans[key] = ExecutionPlan(
            strategy="scan", local_fn=local_fn, ring=ring, sp_degree=self.sp_degree,
            kind="scan", seq_axis=axis)
        return plan


def _hybrid_cost(inner_desc: SPStrategy, shapes: AttnShapes, *, n_pods: int, P_inner: int,
                 bidir_links: bool, extras: dict) -> CommCost:
    """Case-Study-III accounting: every pod step each rank forwards its
    rank-local KV shard (``S_kv / (n_pods * P_inner)`` rows, see
    ``core/hybrid.py``) over the pod ring, and runs a full inner pass over
    the inner ring."""
    S_kv = shapes.seq_kv
    kv_shard = (2 * shapes.B * (S_kv // (n_pods * P_inner)) * shapes.Hkv * shapes.D
                * shapes.dtype_bytes)
    outer = CommCost((n_pods - 1) * kv_shard, 0.0)
    inner = strategy_cost(
        inner_desc, shapes.B, shapes.Sq // n_pods, shapes.Hq, shapes.Hkv, shapes.D, P_inner,
        bytes_per_elem=shapes.dtype_bytes, bidir_links=bidir_links, S_kv=S_kv // n_pods,
        **extras,
    )
    return CommCost(outer.fwd_bytes + n_pods * inner.fwd_bytes,
                    outer.bwd_bytes + n_pods * inner.bwd_bytes)


def choose_strategy(strategy: str, Hq: int, Hkv: int, P_sp: int) -> str:
    """The pre-registry chooser, kept for callers of the reference's API:
    ``"auto"`` arbitrates the ring family (TokenRing against the
    bidirectional KV ring) from head counts alone, by the registered cost
    models at a representative shape; an explicit name is validated and
    returned.  :func:`~repro_torch.core.strategies.resolve_strategy`
    arbitrates over every strategy with the whole shape."""
    if strategy != "auto":
        get_strategy(strategy)
        return strategy
    return resolve_strategy("auto", S=1024 * max(P_sp, 1), Hq=Hq, Hkv=Hkv, D=128, P=P_sp,
                            bytes_per_elem=2, candidates=("tokenring", "ring_bidir"))


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
    # a process group passes its shard: the shapes are global
    shards, data = (1, 1) if ring.folded else (pctx.sp_degree, pctx.data_degree)
    shapes = AttnShapes(B=B * data, Sq=Sq * shards, Hq=Hq, Hkv=Hkv, D=D, Sk=Sk * shards,
                        dtype_bytes=q.element_size())
    plan = pctx.plan(shapes, causal=causal, window=window, scale=scale)
    return plan(q, k, v, q_pos, k_pos)


def sp_decode(q, k_cache, v_cache, k_pos, q_pos, *, pctx: ParallelContext,
              causal: bool = True, window: int | None = None, scale: float | None = None,
              table_pages: int | None = None):
    """Decode attention: ``q (B,Sq,Hq,D)`` with small Sq, replicated, against
    the cache ``(B,Skv,Hkv,D)``; ``k_pos (B,Skv)`` (``PAD_POS`` for unwritten
    slots), ``q_pos (B,Sq)``.  With ``sp_degree > 1`` the cache is
    sequence-sharded and ``k_pos`` required: rank-major ``(P*B, Skv/P, ...)``
    on the virtual ring, this rank's shard ``(B, Skv/P, ...)`` on a process
    group.  ``causal=False`` reads every live slot whatever its position
    (cross-attention against a resident encoder).  ``table_pages``:
    block-table width when the cache is a gathered page view (priced into
    the plan's cost)."""
    from repro_torch.kernels.ops import flash_attention

    B = q.shape[0]
    q_pos = normalize_positions(q_pos, B, q.shape[1], q.device)
    if not pctx.active:
        k_pos = normalize_positions(k_pos, B, k_cache.shape[1], q.device)
        out, _ = flash_attention(
            q, k_cache, v_cache, q_pos=q_pos, k_pos=k_pos, causal=causal, window=window,
            scale=scale, impl=pctx.impl, block_k=pctx.block_k,
        )
        return out
    _check_ring_device(pctx, q)
    k_pos = _sharded_positions(pctx, k_pos, k_cache)
    shapes = AttnShapes(B=B, Sq=q.shape[1], Hq=q.shape[2], Hkv=k_cache.shape[2], D=q.shape[3],
                        Sk=k_cache.shape[1] * pctx.sp_degree, dtype_bytes=q.element_size())
    plan = pctx.plan_decode(causal=causal, window=window, scale=scale, shapes=shapes,
                            table_pages=table_pages)
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


def sp_scan(a, b, *, pctx: ParallelContext, axis: int = 1):
    """Sequence-parallel diagonal linear recurrence ``h_t = a_t h_{t-1} +
    b_t`` along ``axis``: ``a``/``b (B, ..., S, ...)``, float.  With
    ``sp_degree > 1`` the sequence is sharded contiguously over the ring
    (the context's layout does not apply: a recurrence runs in time
    order); the tensors are global on the virtual ring and this rank's
    contiguous shard on a process group.  Differentiable."""
    if not pctx.active:
        from repro_torch.core.recurrence import local_linear_recurrence

        h, _ = local_linear_recurrence(a, b, axis=axis)
        return h
    _check_ring_device(pctx, a)
    return pctx.plan_scan(ndim=a.ndim, axis=axis)(a, b)

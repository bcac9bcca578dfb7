"""What one rank's step costs, counted while the step runs (the counterpart
of ``repro.launch.hlo_analysis.analyze_hlo``).

The reference reads the post-SPMD HLO of a compiled step.  The port has no
compiled artifact: :class:`StepAnalysis` is a ``TorchDispatchMode`` that
watches every operation of one rank's step as it runs, on real tensors or
on fake ones (``torch._subclasses.fake_tensor``, which the dry run,
``launch/dryrun.py``, traces at full size without a card), and counts:

* **dense products** (``DOT_OPS``: mm, addmm, bmm, baddbmm, what ``einsum``
  and ``matmul`` lower to; under inference mode ``matmul``, ``linear`` and
  ``einsum`` reach the mode whole): their flops by
  ``torch.utils.flop_counter``'s formulas (2 a multiply-add), and
  ``dot_bytes``, every operand read once and the result written once;
* **attention**, which runs in the kernels: each wrapper's shape path
  (``kernels.flash_attention.report_fake_call``) hands the call here, and its
  flops are counted by the kernels' own tile skip (``tile_skip_grid`` at the
  instance's tiles) at ``PERF.md`` §6's convention, ``4·D`` a computed
  (query, key, head) pair for A, ``6·D`` for B1, ``8·D`` for B2, beside the
  masked-full count (every pair of the call);
* **collectives**: each ``c10d`` operation the transports issue, its count
  and the bytes handed to it, by kind.  The link bytes a direction and link
  class are the transports' own ledger (``core/collectives.py``), read by the
  caller, not a model;
* **memory**: every storage an operation makes, from its birth to its death
  (a weak reference on the storage, as ``torch.distributed._tools.mem_tracker``
  does), rounded up to the card's caching allocator's 512-byte blocks; the
  high-water of the bytes alive, and at that moment their split into the
  storages registered by :meth:`StepAnalysis.track` (parameters, optimizer
  state, batch, serve state), the gradients (storages the backward made that
  are alive when it ends) and the rest.

**Positions.**  Which tiles a kernel skips depends on the positions it is
given, which a fake tensor does not hold.  The mode keeps a *shadow* of
every integer tensor it can: rank 0's value, a real CPU tensor.  The
caller seeds the shadows (:meth:`StepAnalysis.shadow`: rank 0's block of
the batch positions, or of a decode state's); an integer operation whose
tensor inputs all have one computes its output's on the CPU; a ``c10d``
operation's outputs have none, since they hold another rank's values.  A
kernel call whose positions are both known counts its pairs by the tile
skip.  One whose query or key side arrived over a link is counted by the
layout (``seq_blocks``: every sequence rank's block of the positions): the
mean over every other rank's block (or half-block) of that size, or, both
sides arrived, over the pairs of two such ranks' blocks.  A ring
strategy's pass pairs rank 0's block with each of those once (the
schedule's coverage), so a pass's sum is exact where one side is rank 0's,
and each call is exact where the candidates agree: the zigzag layout with
a causal mask, at tiles no larger than its chunks, where every pair of
two ranks' blocks computes half its pairs.  A call whose
arrived side fits no block counts every pair, and
``attention_calls_unresolved`` counts it.

:func:`roofline` turns the counts into the three terms at the datasheet
figures of an H100 SXM5 80GB HBM3 at 700 W (``PEAK_FLOPS``, ``HBM_BW``,
``NVLINK_BW``, ``NIC_BW``): no link has been measured (one card has none),
and each link class is charged at the bandwidth of the wire its ranks cross.
"""

from __future__ import annotations

import math
import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import is_fake, unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

__all__ = ["StepAnalysis", "StepStats", "roofline", "link_bandwidths", "PEAK_FLOPS", "HBM_BW",
           "NVLINK_BW", "NIC_BW", "NODE_GPUS", "DOT_OPS", "ALLOC_ROUND"]

# Datasheet figures of an H100 SXM5 80GB HBM3 at 700 W, none measured here.
PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s a direction, between the 8 GPUs of a node
NIC_BW = 50e9  # bytes/s a direction between nodes: NDR 400 Gb/s, one NIC a GPU
NODE_GPUS = 8
ALLOC_ROUND = 512  # the CUDA caching allocator's block granularity

aten = torch.ops.aten
DOT_OPS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm)
_PRIM_DEVICE = torch.ops.prim.device.default
# products that reach the mode whole under inference mode, where composite
# operations are not decomposed above it (two-operand einsums)
_COMPOSITE_DOTS = (aten.matmul, aten.linear, aten.einsum)
# ops whose output's shape or value is its input's data
_VALUE_SHAPED = (aten.nonzero.default, aten._local_scalar_dense.default)
# ops whose output holds no value yet: no shadow
_UNINITIALIZED = ("empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided")
# flops a computed (query, key, head) pair and head-dim element, by kernel
ATTENTION_COEF = {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 6,
                  "flash_attention_bwd_dkv": 8, "paged_decode_fwd": 4}


@dataclass
class StepStats:
    """One rank's counts (the reference's ``HloStats``)."""

    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    attention_flops: float = 0.0
    attention_flops_full: float = 0.0
    attention_bytes: float = 0.0
    attention_calls: dict = field(default_factory=dict)
    attention_calls_unresolved: int = 0
    collective_bytes: dict = field(default_factory=dict)
    n_collectives: int = 0

    def as_dict(self) -> dict:
        return {"dot_flops": self.dot_flops, "dot_bytes": self.dot_bytes,
                "attention_flops": self.attention_flops,
                "attention_flops_full": self.attention_flops_full,
                "attention_bytes": self.attention_bytes,
                "attention_calls": dict(self.attention_calls),
                "attention_calls_unresolved": self.attention_calls_unresolved,
                "collective_bytes": dict(self.collective_bytes),
                "n_collectives": self.n_collectives}


def _tensors(out) -> list:
    """The tensors an operation returned (one, or a tuple or list of them
    and other values)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    return []


# the arguments each operation writes (from its schema), by operation
_WRITES: dict = {}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_int(t) -> bool:
    return isinstance(t, torch.Tensor) and not t.is_floating_point() and not t.is_complex()


class StepAnalysis(TorchDispatchMode):
    """Counts one rank's step (module docstring).  ``ledger``: the
    transports' (its gathered bytes at the high-water); ``seq_blocks``
    ``(P, n)``: every sequence rank's block of the positions (rank 0's
    first), for the calls whose positions arrived over a link.

    Use as a context around the step; register the state the step starts
    from with :meth:`track` first.  After it, :attr:`stats` holds the counts
    and :meth:`memory` the high-water and its split."""

    def __init__(self, *, ledger=None, seq_blocks=None):
        super().__init__()
        self.ledger, self.seq_blocks = ledger, seq_blocks
        self.stats = StepStats()
        self._lock = threading.Lock()  # storages die on the autograd engine's thread too
        self._storages = WeakIdKeyDictionary()  # storage -> its record
        self._records: list[list] = []  # [bytes, category, born, died]
        self._seq = 0
        self.live = 0
        self.peak = 0
        self._peak_seq = 0
        self._gathered_at_peak = 0
        self._in_backward = False
        self._backward: list[list] = []  # the records the running backward made
        self._shadows = WeakIdKeyDictionary()
        self._by_layout: dict = {}  # the layout's pair counts, by call

    # ------------------------------------------------------------ memory

    def _see(self, t, category: str | None):
        """Record ``t``'s storage if it is new (``category`` ``None``: what
        the step makes, ``"backward"`` inside the backward)."""
        st = t.untyped_storage()
        with self._lock:
            rec = self._storages.get(st)
            if rec is not None:
                if category is not None and rec[1] in ("other", "backward"):
                    rec[1] = category
                return
            n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
            self._seq += 1
            rec = [n, category or ("backward" if self._in_backward else "other"), self._seq,
                   None]
            self._storages[st] = rec
            self._records.append(rec)
            if rec[1] == "backward":
                self._backward.append(rec)
            self.live += n
            if self.live > self.peak:
                self.peak, self._peak_seq = self.live, self._seq
                if self.ledger is not None:
                    self._gathered_at_peak = self.ledger.gathered_live
        weakref.finalize(st, self._die, rec)

    def _die(self, rec):
        with self._lock:
            self._seq += 1
            rec[3] = self._seq
            self.live -= rec[0]

    def track(self, tree, category: str):
        """Register every tensor of ``tree`` (dicts, lists, tensors, serve
        blocks) as ``category`` (``"params"``, ``"opt"``, ``"batch"``,
        ``"state"``)."""
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            for x in tree:
                self.track(x, category)
        elif isinstance(tree, torch.Tensor):
            self._see(tree, category)
        elif hasattr(tree, "blocks"):
            self._see(tree.blocks, category)

    def memory(self) -> dict:
        """The high-water of the bytes alive and their split at that moment:
        ``params``, ``opt``, ``batch``, ``state``, ``gradients``,
        ``gathered`` (the FSDP gather's full tensors alive then, from the
        ledger) and ``rest``."""
        split = {k: 0 for k in ("params", "opt", "batch", "state", "gradients")}
        rest = 0
        for n, cat, born, died in self._records:
            if born <= self._peak_seq and (died is None or died > self._peak_seq):
                if cat in split:
                    split[cat] += n
                else:
                    rest += n
        gathered = min(self._gathered_at_peak, rest)
        return {"peak_bytes": self.peak, **split, "gathered": gathered, "rest": rest - gathered}

    def _end_backward(self):
        """The backward ended: what it made and is still alive is the
        gradients."""
        with self._lock:
            for rec in self._backward:
                if rec[3] is None:
                    rec[1] = "gradients"
            self._backward = []

    # ----------------------------------------------------------- shadows

    def shadow(self, t, value):
        """Seed ``t``'s shadow: ``value``, rank 0's, of ``t``'s shape."""
        with unset_fake_temporarily():
            value = value.detach().to("cpu")
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"shadow of shape {tuple(value.shape)} for a tensor of "
                             f"{tuple(t.shape)}")
        self._shadows[t] = value

    def value(self, t):
        """Rank 0's value of ``t``: a real tensor's own, a fake one's
        shadow, or ``None``."""
        if not is_fake(t):
            with unset_fake_temporarily():
                return t.detach().to("cpu")
        return self._shadows.get(t)

    def _propagate(self, func, args, kwargs, out):
        """Shadows of a fake ``out``'s integer tensors from the inputs'
        (module docstring); the mutated integer input of an in-place op gets
        its new value, or loses its shadow when none can be computed."""
        outs = [t for t in _tensors(out) if _is_int(t) and is_fake(t)]
        writes = _WRITES.get(func)
        if writes is None:
            writes = _WRITES[func] = tuple(
                i for i, info in enumerate(func._schema.arguments)
                if info.alias_info is not None and info.alias_info.is_write)
        mutated = [args[i] for i in writes
                   if i < len(args) and _is_int(args[i]) and is_fake(args[i])]
        if (not outs and not mutated) or func._overloadpacket.__name__ in _UNINITIALIZED:
            return
        flat, spec = tree_flatten((args, kwargs))
        vals = []
        with unset_fake_temporarily():
            for x in flat:
                if isinstance(x, torch.device):
                    x = torch.device("cpu")
                elif isinstance(x, torch.Tensor):
                    v = self.value(x)
                    if v is None:
                        for t in mutated + outs:
                            self._shadows.pop(t, None)
                        return
                    # an input the op writes is written on a copy
                    x = v.clone() if any(x is m for m in mutated) else v
                vals.append(x)
            a, kw = spec.unflatten(vals)
            try:
                res = func(*a, **kw)
            except (RuntimeError, ValueError, TypeError, IndexError, NotImplementedError):
                for t in mutated + outs:
                    self._shadows.pop(t, None)
                return
        for t, v in zip(tree_flatten(out)[0], tree_flatten(res)[0]):
            if _is_int(t) and is_fake(t) and isinstance(v, torch.Tensor):
                self._shadows[t] = v
        for x, v in zip(flat, vals):
            if any(x is m for m in mutated):
                self._shadows[x] = v

    # --------------------------------------------------------- counting

    def _collective(self, func, args):
        """Count a ``c10d`` operation; what it writes holds another rank's
        values, so loses its shadow."""
        name = func._overloadpacket.__name__.rstrip("_")
        first = [t for t in tree_flatten(args[0])[0] if isinstance(t, torch.Tensor)]
        moved = (first if name in ("send", "recv", "allreduce") else
                 [t for t in tree_flatten(args[1])[0] if isinstance(t, torch.Tensor)])
        if name != "recv":
            self.stats.n_collectives += 1
            self.stats.collective_bytes[name] = (self.stats.collective_bytes.get(name, 0)
                                                 + sum(_nbytes(t) for t in moved))
        if name != "send":
            for t in first:
                self._shadows.pop(t, None)

    def _dot(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        if packet in DOT_OPS:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            operands = args[1:3] if packet in (aten.addmm, aten.baddbmm) else args[:2]
        elif packet is aten.einsum:
            operands = args[1]
            sizes = {}
            for term, t in zip(args[0].replace(" ", "").split("->")[0].split(","), operands):
                sizes.update(zip(term, t.shape))
            flops = 2 * math.prod(sizes.values())
        else:  # matmul, linear: every output element a K-long dot
            operands = args[:2]
            flops = 2 * out.numel() * args[0].shape[-1]
        self.stats.dot_flops += flops
        self.stats.dot_bytes += sum(_nbytes(t) for t in operands) + _nbytes(out)

    def attention_call(self, kernel: str, *, q, Sk: int, q_pos, k_pos, causal: bool,
                       window: int | None, tiles: tuple[int, int], nbytes: int):
        """One kernel call on fake tensors (an observer of
        ``kernels.flash_attention.FAKE_CALL_OBSERVERS``): ``q (B, Sq, Hq,
        D)`` against ``Sk`` keys, the positions (a paged call's
        ``(pos_pool, block_tables)``), the mask and the instance's ``(q
        rows, keys)`` tiles."""
        with _disable_current_modes():  # the shadows are real CPU tensors
            self._attention_call(kernel, q.shape, Sk, q_pos, k_pos, causal, window, tiles,
                                 nbytes)

    def _attention_call(self, kernel, q_shape, Sk, q_pos, k_pos, causal, window, tiles,
                        nbytes):
        from repro_torch.kernels.flash_attention import tile_skip_grid

        B, Sq, Hq, D = q_shape
        coef = ATTENTION_COEF[kernel] * D * Hq
        full = coef * B * Sq * Sk
        qp = self.value(q_pos)
        kp = self._paged_positions(*k_pos) if isinstance(k_pos, tuple) else self.value(k_pos)
        st = self.stats
        st.attention_calls[kernel] = st.attention_calls.get(kernel, 0) + 1
        st.attention_flops_full += full
        st.attention_bytes += nbytes
        if Sq == 0 or Sk == 0:
            return
        if qp is not None and kp is not None:
            pairs = computed_pairs(qp, kp, *tiles, causal=causal, window=window,
                                   skip_grid=tile_skip_grid)
        else:
            pairs = self._layout_pairs(qp, kp, B, Sq, Sk, tiles, causal, window)
        if pairs is None:
            st.attention_calls_unresolved += 1
            st.attention_flops += full
        else:
            st.attention_flops += coef * pairs

    def _layout_pairs(self, qp, kp, B, Sq, Sk, tiles, causal, window):
        """The pairs of a call a side of which arrived over a link: the mean
        over that side's candidates, every other sequence rank's block or
        half-block of its length (both sides arrived: over the pairs of two
        ranks' candidates); ``None`` where no candidate fits (module
        docstring)."""
        from repro_torch.kernels.flash_attention import tile_skip_grid

        qc = [(None, qp)] if qp is not None else self._candidates(Sq, B)
        kc = [(None, kp)] if kp is not None else self._candidates(Sk, B)
        if qc is None or kc is None:
            return None
        key = tuple(None if p is None else (p.shape, p.numpy().tobytes()) for p in (qp, kp))
        key += (B, Sq, Sk, tiles, causal, window)
        if key not in self._by_layout:
            counts = [computed_pairs(q, k, *tiles, causal=causal, window=window,
                                     skip_grid=tile_skip_grid)
                      for rq, q in qc for rk, k in kc if rq is None or rq != rk]
            self._by_layout[key] = sum(counts) / len(counts)
        return self._by_layout[key]

    def _candidates(self, n: int, B: int):
        """``[(rank, positions (B, n))]``: every other sequence rank's
        block, or each half of it, of ``n`` positions; ``None`` if neither
        fits."""
        blocks = self.seq_blocks
        if blocks is None or blocks.shape[1] % n or blocks.shape[1] // n > 2:
            return None
        return [(r, c[None].expand(B, n)) for r in range(1, blocks.shape[0])
                for c in blocks[r].reshape(-1, n)]

    def _paged_positions(self, pos_pool, block_tables):
        """The positions a paged call reads, page by page of each row's
        table (an unmapped entry's page all padding), or ``None``."""
        from repro_torch.kernels.ref import PAD_POS

        pool, bt = self.value(pos_pool), self.value(block_tables)
        if pool is None or bt is None:
            return None
        mapped = (bt >= 0) & (bt < pool.shape[0])
        pages = pool[bt.clamp(0, pool.shape[0] - 1).long()]
        pages = torch.where(mapped[..., None], pages, torch.full_like(pages, PAD_POS))
        return pages.flatten(1)

    def __enter__(self):
        from repro_torch.kernels.flash_attention import FAKE_CALL_OBSERVERS

        FAKE_CALL_OBSERVERS.append(self.attention_call)
        return super().__enter__()

    # ----------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _PRIM_DEVICE:
            return func(*args, **kwargs)
        in_backward = torch._C._current_autograd_node() is not None
        if self._in_backward and not in_backward:
            self._end_backward()
        self._in_backward = in_backward
        if func in _VALUE_SHAPED and is_fake(args[0]):
            return self._from_shadow(func, args, kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.namespace == "c10d":
            with unset_fake_temporarily():  # the shadows are real CPU tensors
                self._collective(func, args)
        elif packet in DOT_OPS or packet in _COMPOSITE_DOTS:
            self._dot(func, args, kwargs, out)
        if func.namespace != "c10d":
            self._propagate(func, args, kwargs, out)
        for t in _tensors(out):
            self._see(t, None)
        return out

    def _from_shadow(self, func, args, kwargs):
        """An operation whose result's shape or value is the input's data
        (``nonzero``, ``item``) on a fake tensor: computed from rank 0's
        shadow, a fake tensor of that shape holding it, or the number."""
        x = args[0]
        with _disable_current_modes():
            v = self.value(x)
            if v is None:
                raise RuntimeError(f"{func} of a fake tensor whose value the dry run does not "
                                   "know: seed its shadow (StepAnalysis.shadow)")
            res = func(v, *args[1:], **kwargs)
        if not isinstance(res, torch.Tensor):
            return res
        out = torch.empty(res.shape, dtype=res.dtype, device=x.device)  # to the fake mode
        self._shadows[out] = res
        self._see(out, None)
        return out

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import FAKE_CALL_OBSERVERS

        FAKE_CALL_OBSERVERS.remove(self.attention_call)
        if self._in_backward:
            self._end_backward()
            self._in_backward = False
        return super().__exit__(*exc)


def computed_pairs(q_pos, k_pos, bq: int, bk: int, *, causal: bool, window: int | None,
                   skip_grid) -> int:
    """(query, key) pairs of the tiles that ``skip_grid`` (the kernels'
    ``tile_skip_grid``) does not skip, at ``bq x bk`` tiles; a ragged last
    tile repeats its last position, which leaves its min and max as they
    are, and counts only its real rows and keys."""
    B, Sq = q_pos.shape
    Sk = k_pos.shape[1]

    def pad(p, b):
        n = -(-p.shape[1] // b) * b
        return torch.cat([p, p[:, -1:].expand(B, n - p.shape[1])], 1) if n > p.shape[1] else p

    skip = skip_grid(pad(q_pos, bq), pad(k_pos, bk), bq, bk, causal=causal, window=window)
    rq = torch.full((skip.shape[1],), bq, dtype=torch.int64)
    rq[-1] = Sq - bq * (skip.shape[1] - 1)
    rk = torch.full((skip.shape[2],), bk, dtype=torch.int64)
    rk[-1] = Sk - bk * (skip.shape[2] - 1)
    return int(((~skip).to(torch.int64) * rq[None, :, None] * rk[None, None, :]).sum())


def link_bandwidths(mesh, rank: int = 0) -> dict[str, float]:
    """Each ledger class's bandwidth a direction: NVLink when every rank of
    ``rank``'s group of the class's axes sits in its node of ``NODE_GPUS``
    (row-major rank order), else the NIC."""
    if mesh is None:
        return {}
    sp = ("pod", "model") if "pod" in mesh.axis_names else ("model",)
    axes = {"link": sp, "intra": ("model",), "inter": ("pod",), "tp": ("model",),
            "data": tuple(a for a in ("pod", "data") if a in mesh.axis_names)}
    out = {}
    for cls, ax in axes.items():
        ax = tuple(a for a in ax if a in mesh.axis_names)
        if not ax:
            continue
        nodes = {r // NODE_GPUS for r in mesh.group(ax, rank)}
        out[cls] = NVLINK_BW if len(nodes) == 1 else NIC_BW
    return out


def roofline(stats: StepStats, class_bytes: dict, bandwidths: dict) -> dict:
    """The three terms of one rank's step at the datasheet figures: compute
    (products and the attention the kernels compute), memory (the bytes the
    products and kernels read and write) and collectives (each ledger class's
    larger direction at its own bandwidth, summed: the classes share a
    rank's NIC)."""
    compute = (stats.dot_flops + stats.attention_flops) / PEAK_FLOPS
    memory = (stats.dot_bytes + stats.attention_bytes) / HBM_BW
    coll = 0.0
    for cls, b in class_bytes.items():
        bw = bandwidths.get(cls, NIC_BW)
        coll += max(b["fwd"], b["bwd"]) / bw
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": coll}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant, "bound_s": max(terms.values()),
            "compute_masked_full_s": (stats.dot_flops + stats.attention_flops_full)
            / PEAK_FLOPS}

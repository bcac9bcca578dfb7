"""Batched serving engine: continuous batching, chunked prefill, paged KV,
prefix reuse and the resilience layer (port of ``repro.serving.engine``).

  * fixed ``max_batch`` decode slots; requests join as slots free up;
  * chunked prefill: a joining prompt is fed through ``prefill_chunk`` in
    chunks of ``prefill_chunk`` tokens while other slots keep decoding;
    a family without it (the encoder-decoder) is fed token by token
    through decode steps at admission, the other slots' lengths rolled
    back (only for a ``decode_rollback_safe`` serve state);
  * a token-budget scheduler: decoding slots each emit one token per
    iteration, prefilling slots share ``token_budget - n_decoding`` tokens
    FCFS (``None`` = unmetered);
  * a paged KV cache (``page_size=``): admission gated on free pages,
    page-granular decode growth, and recompute-style preemption of the
    newest request when the pool runs dry;
  * a content-addressed prefix cache (``prefix_cache=True``, paged only):
    requests sharing a prompt prefix map the same physical pages
    (:class:`~repro_torch.serving.kv_cache.PrefixIndex`), prefill resumes at
    the hit, and a divergence inside a resident page is copied into a
    private page first (copy-on-write); unreferenced index pages are
    evicted before a live request is preempted;
  * the resilience layer (``serving/resilience.py``): a deterministic
    ``fault_plan`` fired at named tick points, per-request quarantine and
    retry with bounded exponential backoff, the degrade ladder, a periodic
    cache audit, and serving-state snapshots (``snapshot_dir=``) from which
    a killed engine restarts token-exact (:meth:`ServingEngine.from_snapshot`);
  * greedy (``argmax``) or temperature sampling from an explicit
    ``torch.Generator``; EOS stops a request and is never emitted.

The JAX engine updates its device state through jitted, donated functions;
here the model steps, slot resets, page releases and copy-on-write copies
update the state tensors in place.  Every page that leaves a slot or the
index has its position rows reset to ``PAD_POS`` before it can be mapped
again: kernels A and C skip keys by position, so a stale position would be
a silently wrong answer.  The engine never drops to the CPU: asking for
``device="cuda"`` on a machine without a card raises.

Sequence-parallel serving (a bundle whose ``pctx`` has ``sp_degree > 1``):
on the virtual ring one engine holds every rank's shard of the state; on a
process group every rank runs the same engine on the same requests, takes
the same host decisions (admission, block tables, allocator, prefix index,
fault plan, sampling from the same replicated logits with the same seed)
and holds only its shard of the cache (its slots of the dense slab, its
stripe of pages).  A copy-on-write whose source and destination pages lie
on different stripes is broadcast by the source's rank and written by the
destination's; a snapshot writes one shard file per rank.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.ref import PAD_POS
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.serving.kv_cache import (
    PageAllocator,
    PrefixIndex,
    dense_slot_rows,
    local_pages,
    pages_for,
    sp_ranks,
)
from repro_torch.serving.resilience import (
    CacheAuditor,
    DegradeLadder,
    IntegrityError,
    LoadShedError,
    ServingFault,
    export_serving_state,
    import_serving_state,
)

__all__ = ["Request", "ServingEngine"]


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (len,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    # filled by the engine:
    output: list = field(default_factory=list)
    stopped_eos: bool = False  # retired by sampling eos_id (not in output)
    status: str = "queued"  # queued | running | retrying | done | failed
    retries: int = 0  # quarantine rounds survived so far
    error: str | None = None  # last fault message (retrying/failed)
    t_submit: float = 0.0
    t_first: float | None = None
    t_done: float | None = None


class ServingEngine:
    """Continuous-batching engine over a :class:`~repro_torch.models.registry.ModelBundle`.

    Knobs as in the JAX engine: ``max_batch`` / ``max_len`` (slots and
    per-slot capacity), ``prefill_chunk``, ``token_budget``, ``page_size``
    (paged cache; ``None`` keeps the dense slab), ``max_pages`` (pool size,
    default dense-equivalent), ``preempt``, ``prefix_cache``, and the
    resilience knobs ``fault_plan``, ``audit_every``, ``max_retries``,
    ``retry_backoff``, ``snapshot_dir``, ``snapshot_every`` and
    ``straggler``.  ``device`` is where the state lives and the steps run;
    ``params`` must already be there.
    """

    def __init__(self, bundle, params, *, max_batch: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0, prefill_chunk: int = 32,
                 token_budget: int | None = None, page_size: int | None = None,
                 max_pages: int | None = None, preempt: bool = True,
                 prefix_cache: bool = False, fault_plan=None, audit_every: int = 0,
                 max_retries: int = 2, retry_backoff: int = 1,
                 snapshot_dir: str | None = None, snapshot_every: int = 0,
                 straggler: StragglerDetector | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine(device='cuda') needs a CUDA device and none is available; "
                "pass device='cpu' to serve on the CPU"
            )
        if max_retries < 0 or retry_backoff < 1:
            raise ValueError(f"need max_retries >= 0 and retry_backoff >= 1, got "
                             f"{max_retries}/{retry_backoff}")
        if snapshot_every and snapshot_dir is None:
            raise ValueError("snapshot_every needs snapshot_dir=")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        if prefix_cache and page_size is None:
            raise ValueError("prefix_cache needs the paged KV cache (set page_size=): "
                             "cross-request page sharing has no dense-slab analog")
        self.bundle = bundle
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget
        self.preempt = preempt
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._sp = sp_ranks(bundle.pctx)  # (P, rank) of the state's layout

        self._paged = page_size is not None
        if self._paged:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if (bundle.prefill_chunk_paged is None or bundle.decode_step_paged is None
                    or bundle.init_paged_state is None):
                raise NotImplementedError(
                    f"family {bundle.cfg.family!r} has no paged serving steps; drop "
                    "page_size= to serve from the dense slab")
            self.page_size = page_size
            self.slot_pages = pages_for(max_len, page_size)
            self.cap = self.slot_pages * page_size  # logical per-slot tokens
            self.max_pages = max_pages if max_pages is not None else max_batch * self.slot_pages
            if self.max_pages < 1:
                raise ValueError(f"max_pages must be >= 1, got {self.max_pages}")
            self.NULL = self.max_pages  # unmapped block-table sentinel
            self.alloc = PageAllocator(self.max_pages, stripes=self._sp[0])
            self.prefix = PrefixIndex(page_size) if prefix_cache else None
            self._bt = np.full((max_batch, self.slot_pages), self.NULL, np.int32)
            self._bt_dirty = False
            self.state = bundle.init_paged_state(
                self.max_pages, page_size, max_batch, self.slot_pages, self.device
            )
            self._step = bundle.decode_step_paged
            self._chunk_step = bundle.prefill_chunk_paged
        else:
            self.page_size = None
            self.prefix = None
            self.cap = max_len
            self.state = bundle.init_serve_state(max_batch, max_len, self.device)
            self._step = bundle.decode_step
            self._chunk_step = bundle.prefill_chunk
            if self._chunk_step is None and not bundle.decode_rollback_safe:
                # a recurrent state advances every row at each step and cannot
                # be rolled back per slot: the token-by-token prefill below
                # would corrupt the concurrent requests
                raise NotImplementedError(
                    f"family {bundle.cfg.family!r} has no chunked prefill and its "
                    "recurrent serve state cannot be rolled back per slot; batched "
                    "serving needs masked decode steps for this family")
        # families without a chunked prefill feed the prompt through decode
        # steps at admission (_prefill_slot_fallback)
        self._chunked = self._chunk_step is not None

        self.slots: list[Request | None] = [None] * max_batch
        self.queue: list[Request] = []
        self.done: list[Request] = []
        self._uid = 0
        self._hold_decode: set[int] = set()  # first decode deferred (budget)
        self.counters = {
            "decode_steps": 0,
            "prefill_steps": 0,
            "prefill_tokens": 0,
            "preemptions": 0,
            "eos_stops": 0,
            "faults": 0,
            "quarantines": 0,
            "failures": 0,
            "recoveries": 0,
            "integrity_errors": 0,
            "load_shed": 0,
            "snapshots": 0,
            "straggler_events": 0,
        }

        # ---- resilience layer (serving/resilience.py) -------------------
        self.fault_plan = fault_plan
        self.audit_every = audit_every
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.snapshot_every = snapshot_every
        self.ladder = DegradeLadder()
        self.auditor = CacheAuditor(self)
        # post-recovery sweeps and those that found a violation (kept out of
        # ``counters``, which match the JAX engine's key for key)
        self.audits = {"post_recovery": 0, "post_recovery_violations": 0}
        self.straggler = straggler if straggler is not None else StragglerDetector()
        self._tick = 0
        self._ckpt = (self._manager(bundle, snapshot_dir, keep=2) if snapshot_dir is not None
                      else None)

    @staticmethod
    def _manager(bundle, snapshot_dir, keep=3):
        """The snapshot manager; on a process group every rank writes its
        own shard of the state."""
        from repro_torch.checkpoint.manager import CheckpointManager

        ring = bundle.pctx.ring
        group = None if ring is None or ring.folded else ring.group
        return CheckpointManager(snapshot_dir, keep=keep, group=group)

    # ------------------------------------------------------------- API

    def submit(self, prompt, max_new_tokens=16, eos_id=None) -> Request:
        """Queue a request.  The prompt must fit one slot's capacity;
        generation past capacity is truncated (the request retires at the
        last writable position).  While the degrade ladder is shedding,
        raises :class:`~repro_torch.serving.resilience.LoadShedError`."""
        if not self.ladder.allow_admission:
            self.counters["load_shed"] += 1
            raise LoadShedError(f"admission shed: degrade ladder at {self.ladder.name!r} "
                                f"after {self.counters['faults']} fault(s)")
        prompt = np.asarray(prompt, np.int32)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size >= self.cap:
            kind = (f"paged capacity {self.cap} ({self.slot_pages} pages x {self.page_size})"
                    if self._paged else f"max_len={self.max_len}")
            raise ValueError(f"prompt of {prompt.size} tokens cannot fit {kind}")
        if self._paged and pages_for(prompt.size - 1, self.page_size) > self.max_pages:
            raise ValueError(
                f"prompt of {prompt.size} tokens needs "
                f"{pages_for(prompt.size - 1, self.page_size)} pages; the pool holds "
                f"{self.max_pages} — it can never be admitted"
            )
        self._uid += 1
        req = Request(uid=self._uid, prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_id=eos_id)
        req._tokens = prompt  # grows to prompt+output on preemption resume
        req._pages = []
        req._ready_tick = 0  # earliest tick _admit may take it (backoff)
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        return req

    def run(self, *, max_steps: int = 10_000):
        """Drive until queue and slots drain (or ``max_steps`` ticks).

        Each tick admits, runs one prefill chunk step and one decode step,
        then the resilience bookkeeping: faults handled at their site or
        here advance the degrade ladder, fault-free ticks cool it; a tick
        that saw a fault ends with a cache audit; periodic audits run every
        ``audit_every`` ticks and snapshots every ``snapshot_every``."""
        for _ in range(max_steps):
            self._tick += 1
            t0 = time.perf_counter()
            faults_before = self.counters["faults"]
            try:
                self._admit()
                if all(s is None for s in self.slots) and not self.queue:
                    break
                if self._chunked:
                    self._prefill_tick()
                self._decode_once()
            except ServingFault as e:
                self._recover(e)
            if self.counters["faults"] > faults_before:
                self._post_recovery_audit()
            else:
                self.ladder.record_clean(self._tick)
                if self.audit_every and self._tick % self.audit_every == 0:
                    try:
                        self.auditor.check()
                    except IntegrityError as e:
                        self._recover(e)
            if self.straggler.record(self._tick, time.perf_counter() - t0):
                self.counters["straggler_events"] += 1
            if (self._ckpt is not None and self.snapshot_every
                    and self._tick % self.snapshot_every == 0
                    and (self.queue or any(s is not None for s in self.slots))):
                self.snapshot()
        return self.done

    # ------------------------------------------------- fault handling

    def _fire(self, point, uid=None):
        """Give the fault plan its shot at this tick point; raises
        :class:`~repro_torch.serving.resilience.InjectedFault` when it
        schedules one.  Every fire point precedes the state it guards."""
        if self.fault_plan is not None:
            self.fault_plan.fire(point, uid=uid)

    def _note_fault(self, err):
        self.counters["faults"] += 1
        self.ladder.record_fault(self._tick)

    def _slot_of(self, uid):
        for i, r in enumerate(self.slots):
            if r is not None and r.uid == uid:
                return i
        return None

    def _requeue(self, req):
        # Priority = uid order = FCFS.
        uids = [r.uid for r in self.queue]
        self.queue.insert(bisect.bisect_left(uids, req.uid), req)

    def _release_slot(self, i):
        """Take slot ``i``'s request out of the batch, freeing its pages and
        keeping prompt + generated tokens for a recompute-style resume."""
        req = self.slots[i]
        if self._paged:
            self._free_slot_pages(i)
        self.slots[i] = None
        self._hold_decode.discard(i)
        if req.output:
            req._tokens = np.concatenate([req.prompt, np.asarray(req.output, np.int32)])
        req._filled = 0
        req._cached = 0
        req._pages = []
        return req

    def _register_retry(self, req, err):
        """Quarantine bookkeeping for a faulted request: bounded
        exponential backoff, then permanent failure."""
        self.counters["quarantines"] += 1
        req.retries += 1
        req.error = str(err)
        if req.retries > self.max_retries:
            req.status = "failed"
            req.t_done = time.perf_counter()
            self.done.append(req)
            self.counters["failures"] += 1
            return
        req.status = "retrying"
        req._ready_tick = self._tick + self.retry_backoff * (2 ** (req.retries - 1))
        self._requeue(req)

    def _quarantine_slot(self, i, err):
        """Pull the faulted request out of its slot (the rest of the batch
        keeps decoding) and schedule its retry."""
        self._register_retry(self._release_slot(i), err)

    def _recover(self, err):
        """Recovery for faults that escape to the run loop: attributable
        ones quarantine their request, integrity errors restore the latest
        snapshot, bare engine-level faults cost only the tick."""
        self._note_fault(err)
        if isinstance(err, IntegrityError):
            self.counters["integrity_errors"] += 1
            self._restore_or_raise(err)
        elif err.uid is not None:
            i = self._slot_of(err.uid)
            if i is not None:
                self._quarantine_slot(i, err)
            else:
                for qi, r in enumerate(self.queue):
                    if r.uid == err.uid:
                        self.queue.pop(qi)
                        self._register_retry(r, err)
                        break
        self.counters["recoveries"] += 1

    def _post_recovery_audit(self):
        """Invariant sweep after a tick that recovered from a fault; a
        violation means recovery itself corrupted state: restore."""
        v = self.auditor.violations()
        self.audits["post_recovery"] += 1
        if v:
            self.audits["post_recovery_violations"] += 1
            err = IntegrityError(v)
            self._note_fault(err)
            self.counters["integrity_errors"] += 1
            self._restore_or_raise(err)
            self.counters["recoveries"] += 1

    def _restore_or_raise(self, err):
        if self._ckpt is None or self._ckpt.latest_step() is None:
            raise err
        self.restore_snapshot()
        self.auditor.check()  # the restored state must itself be clean

    # --------------------------------------------------------- internals

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            qi = self._next_ready()
            if qi is None:
                break
            req = self.queue[qi]
            try:
                self._fire("admit", uid=req.uid)
                if not self._admit_into(i, qi, req):
                    break  # page exhaustion: strict FCFS, later requests wait
            except ServingFault as e:
                # the request never entered a slot: quarantine it, keep admitting
                self._note_fault(e)
                self.queue.pop(qi)
                self._register_retry(req, e)

    def _next_ready(self):
        """Queue index of the next admittable request: FCFS over requests
        whose backoff has elapsed, skipping fresh requests while the ladder
        sheds (retries keep their admission rights)."""
        for qi, req in enumerate(self.queue):
            if getattr(req, "_ready_tick", 0) > self._tick:
                continue
            if not self.ladder.allow_admission and req.retries == 0:
                continue
            return qi
        return None

    def _admit_into(self, i, qi, req) -> bool:
        """Admit ``req`` (queue position ``qi``) into free slot ``i``; False
        when the page pool cannot cover it (the caller defers)."""
        hit_tokens = 0
        if self._paged:
            need = pages_for(len(req._tokens) - 1, self.page_size)
            hit = None
            n_hit = 0
            if self.prefix is not None and self.ladder.allow_splice:
                # only rows the prefill would write (tokens[:-1]) can be reused
                hit = self.prefix.lookup(req._tokens[:-1])
                n_hit = len(hit.pages)
            self._fire("alloc", uid=req.uid)
            # never evict what this admission is about to map or copy
            keep = (list(hit.pages) + ([hit.cow_page] if hit.cow_page is not None else [])
                    if hit else ())
            fresh = self._alloc_pages(need - n_hit, keep=keep)
            if fresh is None:
                return False
            cow = hit is not None and hit.cow_page is not None and hit.cow_keep > 0
            if cow:
                try:
                    self._fire("cow", uid=req.uid)
                except ServingFault:
                    self.alloc.free(fresh)  # nothing acquired yet: roll back
                    raise
            if hit is not None:
                self.prefix.acquire(hit.pages)
                hit_tokens = hit.tokens
                if cow:
                    # divergence inside a resident page: copy it into this
                    # request's first private page, the resident page untouched
                    self._cow_copy(hit.cow_page, fresh[0], hit.cow_keep)
                    self.prefix.cow_copies += 1
            req._pages = list(hit.pages if hit else []) + fresh
            self._bt[i, :] = self.NULL
            self._bt[i, :need] = req._pages
            self._bt_dirty = True
        self.queue.pop(qi)
        self.slots[i] = req
        req.status = "running"
        self._reset_slot(i, hit_tokens)
        req._filled = hit_tokens  # prompt tokens already in the cache
        req._cached = hit_tokens  # total cache slots written
        if not self._chunked:
            self._prefill_slot_fallback(i, req)
        elif not self._prefilling(req):
            # prompt fully resident (one token, or a full prefix hit)
            req._next_token = int(req._tokens[-1])
        return True

    @torch.inference_mode()
    def _reset_slot(self, i, n=0):
        """In-place slot reset to length ``n``.  Paged: only the length
        (freed pages already had their position rows restored; with a
        prefix hit the hit pages' rows are valid and prefill resumes at
        ``n``).  Dense: length 0 and the slot's position row."""
        self.state["len"][i] = n
        if not self._paged:
            self.state["pos"][dense_slot_rows(i, self.max_batch, *self._sp)] = PAD_POS

    def _local(self, pages):
        """Global page ids as indices into the pool this process holds, and
        which of them it holds (on a process group, its stripe only)."""
        idx = local_pages(torch.as_tensor(pages, dtype=torch.long, device=self.device),
                          self.max_pages, *self._sp)
        return idx, idx < self.state["pos"].shape[0]

    @torch.inference_mode()
    def _mask_pages(self, pages):
        """Reset the position rows of ``pages`` to ``PAD_POS``, so a future
        owner never attends their stale keys."""
        idx, held = self._local(pages)
        self.state["pos"][idx[held]] = PAD_POS

    @torch.inference_mode()
    def _cow_copy(self, src, dst, keep):
        """Copy page ``src`` into private page ``dst``, keeping only its first
        ``keep`` position entries valid (the rows past the divergence stay
        masked until this request's prefill overwrites them).  The shared
        source is read, never written.  On a process group whose stripes
        put the two pages on different ranks, the source's rank broadcasts
        the page and the destination's writes it."""
        st = self.state
        offs = torch.arange(self.page_size, device=self.device)
        P, rank = self._sp
        if rank is None or src * P // self.max_pages == dst * P // self.max_pages:
            (s, d), held = self._local([src, dst])
            if bool(held[0]):
                st["k"][:, d] = st["k"][:, s]
                st["v"][:, d] = st["v"][:, s]
                st["pos"][d] = torch.where(offs < keep, st["pos"][s], PAD_POS)
            return
        import torch.distributed as dist

        ring = self.bundle.pctx.ring
        owner = src * P // self.max_pages
        n_local = self.max_pages // P
        shape = st["k"].shape
        k = torch.empty((shape[0],) + tuple(shape[2:]), dtype=st["k"].dtype, device=self.device)
        v = torch.empty_like(k)
        pos = torch.empty((self.page_size,), dtype=st["pos"].dtype, device=self.device)
        if rank == owner:
            s = src - owner * n_local
            k.copy_(st["k"][:, s])
            v.copy_(st["v"][:, s])
            pos.copy_(st["pos"][s])
        root = (dist.get_global_rank(ring.group, owner) if ring.group is not dist.group.WORLD
                else owner)
        for buf in (k, v, pos):
            dist.broadcast(buf, src=root, group=ring.group)
        if rank == dst * P // self.max_pages:
            d = dst - rank * n_local
            st["k"][:, d] = k
            st["v"][:, d] = v
            st["pos"][d] = torch.where(offs < keep, pos, PAD_POS)

    def _alloc_pages(self, n, keep=()):
        """Allocate ``n`` pool pages, evicting unreferenced prefix-index
        pages (never those of ``keep``: the admission's own hit and its
        copy-on-write source) to cover a shortfall; ``None`` when the pool
        cannot supply them (the caller defers admission or preempts).  The
        JAX engine may evict its hit here and then fail to acquire it
        (``page ... is not index-owned``), or evict its COW source and copy
        a masked page."""
        if n <= 0:
            return []
        short = n - self.alloc.free_pages
        if short > 0 and self.prefix is not None:
            self._drop_indexed(self.prefix.evict(short, keep=keep))
        try:
            return self.alloc.alloc(n)
        except MemoryError:
            return None

    def _drop_indexed(self, pages):
        """Return evicted (refcount-0) index pages to the allocator with
        their position rows masked."""
        if not pages:
            return
        self.alloc.free(pages)
        self._mask_pages(pages)

    def _prefilling(self, req) -> bool:
        return getattr(req, "_filled", 0) < len(req._tokens) - 1

    @torch.inference_mode()
    def _sync_bt(self):
        if self._paged and self._bt_dirty:
            self.state["block_tables"].copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False

    # ---- paged bookkeeping ----------------------------------------------

    def _free_slot_pages(self, i):
        """Return slot ``i``'s private pages to the pool with their position
        rows reset; pages the prefix index owns are only dereferenced (they
        stay resident, other slots may be attending them)."""
        pages = [int(p) for p in self._bt[i] if p != self.NULL]
        if self.prefix is not None:
            pages = [p for p in pages if not self.prefix.release(p)]
        if pages:
            self.alloc.free(pages)
            self._mask_pages(pages)
        self._bt[i, :] = self.NULL
        self._bt_dirty = True

    def _evict(self, i):
        """Preempt slot ``i``: free its pages and re-queue the request (it
        re-prefills prompt + output on re-admission)."""
        req = self._release_slot(i)
        self.counters["preemptions"] += 1
        req.status = "queued"
        self._requeue(req)

    def _pick_victim(self, requester_i):
        """Newest occupant, or None if the requester is alone."""
        occ = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        i, _ = max(occ, key=lambda t: t[1].uid)
        if i == requester_i and len(occ) == 1:
            return None
        return i

    def _grow_pages(self, hold):
        """Map a fresh page for every decoding slot whose next write crosses
        a page boundary: evict an unreferenced index page first, then
        preempt (newest first) when the pool is dry."""
        cands = sorted(
            ((i, r) for i, r in enumerate(self.slots)
             if r is not None and not self._prefilling(r) and i not in hold),
            key=lambda t: t[1].uid,
        )
        for i, req in cands:
            if self.slots[i] is not req:
                continue  # already evicted as someone's victim
            tbl = req._cached // self.page_size
            if self._bt[i, tbl] != self.NULL:
                continue
            try:
                self._fire("alloc", uid=req.uid)
            except ServingFault as e:
                # quarantine this request (its output survives), keep growing
                self._note_fault(e)
                self._quarantine_slot(i, e)
                continue
            while True:
                try:
                    page = self.alloc.alloc(1)[0]
                except MemoryError:
                    if self.prefix is not None:
                        dropped = self.prefix.evict(1)
                        if dropped:
                            self._drop_indexed(dropped)
                            continue
                    if not self.preempt:
                        raise RuntimeError(
                            f"KV page pool exhausted ({self.max_pages} pages) and "
                            "preemption is disabled"
                        ) from None
                    victim = self._pick_victim(i)
                    if victim is None:
                        raise RuntimeError(
                            "KV page pool exhausted: the remaining request alone needs "
                            "more pages than the pool holds"
                        ) from None
                    try:
                        self._fire("evict", uid=self.slots[victim].uid)
                    except ServingFault as e:
                        # the eviction faulted: quarantine the victim instead
                        self._note_fault(e)
                        self._quarantine_slot(victim, e)
                    else:
                        self._evict(victim)
                    if victim == i:
                        break  # evicted ourselves; skip decode this round
                    continue
                self._bt[i, tbl] = page
                req._pages.append(page)
                self._bt_dirty = True
                break

    # ---- chunked prefill ------------------------------------------------

    def _prefill_tick(self):
        """Split the token budget FCFS across prefilling slots and run one
        batched chunk step; a prompt that finishes registers its full pages
        in the prefix index."""
        self._fire("prefill_tick")
        prefilling = sorted(
            ((i, r) for i, r in enumerate(self.slots) if r is not None and self._prefilling(r)),
            key=lambda t: t[1].uid,
        )
        if not prefilling:
            return
        n_decode = sum(1 for r in self.slots if r is not None and not self._prefilling(r))
        if self.token_budget is None:
            budget = len(prefilling) * self.prefill_chunk
        else:
            budget = max(self.token_budget - n_decode, 0)
        C = self.prefill_chunk
        tokens = np.zeros((self.max_batch, C), np.int32)
        n_valid = np.zeros((self.max_batch,), np.int32)
        for i, req in prefilling:
            a = min(len(req._tokens) - 1 - req._filled, C, budget)
            if a <= 0:
                continue
            tokens[i, :a] = req._tokens[req._filled:req._filled + a]
            n_valid[i] = a
            budget -= a
        if not n_valid.any():
            return
        self._sync_bt()
        self._chunk_step(self.params, torch.from_numpy(tokens).to(self.device), self.state,
                         torch.from_numpy(n_valid).to(self.device))
        self.counters["prefill_steps"] += 1
        self.counters["prefill_tokens"] += int(n_valid.sum())
        for i, req in prefilling:
            req._filled += int(n_valid[i])
            req._cached += int(n_valid[i])
            if not self._prefilling(req):
                # The last prompt token is fed by the slot's first decode step.
                req._next_token = int(req._tokens[-1])
                if self.prefix is not None and self.ladder.allow_share:
                    # already-shared hit pages are skipped (same key)
                    self.prefix.register(req._tokens[:req._filled],
                                         [int(p) for p in self._bt[i] if p != self.NULL])
                if self.token_budget is not None:
                    # Metered: this iteration's budget went to the prefill;
                    # the first decode waits one iteration.
                    self._hold_decode.add(i)

    # ---- token-by-token fallback (families without prefill_chunk) -------

    def _prefill_slot_fallback(self, i, req):
        """Feed the prompt through decode steps for slot ``i`` alone: every
        other row gets a dummy token and the lengths of the occupied ones
        are rolled back after each step.  Exact, but O(prompt) steps that
        stall the batch; the chunked path replaces it wherever the family
        has ``prefill_chunk``."""
        others = [j for j, s in enumerate(self.slots) if s is not None and j != i]
        lens_before = self.state["len"].clone()
        for tok in req._tokens[:-1]:
            toks = np.zeros((self.max_batch,), np.int32)
            toks[i] = tok
            self._step(self.params, torch.from_numpy(toks).to(self.device), self.state)
            if others:
                self.state["len"][others] = lens_before[others]
        req._filled = len(req._tokens) - 1  # prefill complete: decode phase
        req._cached = req._filled
        req._next_token = int(req._tokens[-1])

    # ---- decode ---------------------------------------------------------

    @torch.inference_mode()
    def _sample(self, logits):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    def _decode_once(self):
        self._fire("decode_once")
        hold, self._hold_decode = self._hold_decode, set()
        if self._paged:
            self._grow_pages(hold)
        toks = np.zeros((self.max_batch,), np.int32)
        active = []
        for i, req in enumerate(self.slots):
            if req is None or self._prefilling(req) or i in hold:
                continue
            toks[i] = req._next_token
            active.append(i)
        if not active:
            return
        self._sync_bt()
        toks = torch.from_numpy(toks).to(self.device)
        if self._chunked:
            mask = np.zeros((self.max_batch,), bool)
            mask[active] = True
            logits, _ = self._step(self.params, toks, self.state,
                                   torch.from_numpy(mask).to(self.device))
        else:  # as the JAX engine: every row steps, idle rows on a dummy token
            logits, _ = self._step(self.params, toks, self.state)
        self.counters["decode_steps"] += 1
        nxt = self._sample(logits).cpu().numpy()
        now = time.perf_counter()
        for i in active:
            req = self.slots[i]
            try:
                self._fire("sample", uid=req.uid)
            except ServingFault as e:
                # this request's token is discarded with the slot (greedy
                # decode recomputes it on resume); the others keep theirs
                self._note_fault(e)
                self._quarantine_slot(i, e)
                continue
            req._cached += 1  # the fed token was written at cache slot len-1
            tok = int(nxt[i])
            if req.t_first is None:
                req.t_first = now
            stopped_eos = req.eos_id is not None and tok == req.eos_id
            if stopped_eos:
                req.stopped_eos = True
                self.counters["eos_stops"] += 1
            else:
                req.output.append(tok)
                req._next_token = tok
            finished = stopped_eos or len(req.output) >= req.max_new_tokens
            if finished or req._cached >= self.cap:
                req.status = "done"
                req.t_done = now
                self.done.append(req)
                self.slots[i] = None
                if self._paged:
                    self._free_slot_pages(i)
                    self.alloc.defrag_order()

    # ------------------------------------------------- snapshot / restore

    def snapshot(self) -> int:
        """Checkpoint the complete serving state under ``snapshot_dir``: the
        device pools (K/V, positions, block tables, lengths, or the dense
        slab) through :class:`~repro_torch.checkpoint.manager.CheckpointManager`,
        the host bookkeeping in the manifest's ``extra`` sidecar.  Returns
        the step id (the engine tick)."""
        if self._ckpt is None:
            raise RuntimeError("snapshot needs snapshot_dir= at construction")
        self._sync_bt()
        self._ckpt.save(self._tick, self.state, extra={"serving": export_serving_state(self)})
        self.counters["snapshots"] += 1
        return self._tick

    def restore_snapshot(self, step: int | None = None) -> int:
        """Rehydrate this engine from snapshot ``step`` (default latest): the
        device state in place, the host bookkeeping from the sidecar.
        Request objects are rebuilt: handles from earlier ``submit`` calls
        do not track the restored engine."""
        if self._ckpt is None:
            raise RuntimeError("snapshot needs snapshot_dir= at construction")
        if step is None:
            step = self._ckpt.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed snapshot under {self._ckpt.dir}")
        self._ckpt.restore(step, self.state)
        import_serving_state(self, self._ckpt.manifest(step)["extra"]["serving"])
        return step

    @classmethod
    def from_snapshot(cls, bundle, params, snapshot_dir, *, step=None, **overrides):
        """Kill-and-restart: rebuild an engine from its serving snapshot.
        Construction kwargs come from the snapshot's config record
        (``overrides`` win, e.g. ``device=`` or a fresh ``fault_plan``)."""
        ckpt = cls._manager(bundle, snapshot_dir)
        if step is None:
            step = ckpt.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed snapshot under {snapshot_dir}")
        cfg = ckpt.manifest(step)["extra"]["serving"]["config"]
        kwargs = {k: cfg[k] for k in (
            "max_batch", "max_len", "temperature", "prefill_chunk", "token_budget", "page_size",
            "max_pages", "preempt", "prefix_cache", "audit_every", "max_retries",
            "retry_backoff", "snapshot_every")}
        kwargs["snapshot_dir"] = snapshot_dir
        kwargs.update(overrides)
        eng = cls(bundle, params, **kwargs)
        eng.restore_snapshot(step)
        return eng

    # ------------------------------------------------------------ stats

    def stats(self):
        lat = [r.t_done - r.t_submit for r in self.done if r.t_done]
        ttft = [r.t_first - r.t_submit for r in self.done if r.t_first]
        out = {
            "requests": len(self.done),
            "tokens": sum(len(r.output) for r in self.done),
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            **self.counters,
        }
        out["failed_requests"] = sum(1 for r in self.done if r.status == "failed")
        out["degrade"] = {"level": self.ladder.level, "mode": self.ladder.name,
                          "escalations": self.ladder.escalations}
        out["audits"] = dict(self.audits)
        out["step_time"] = {"median_s": self.straggler.median,
                            "straggler_events": len(self.straggler.events)}
        if self._paged:
            out["pages"] = self.alloc.utilization()
        if self.prefix is not None:
            out["prefix"] = self.prefix.stats()
        return out

"""Batched serving engine: continuous batching, chunked prefill, paged KV
(port of ``repro.serving.engine``).

  * fixed ``max_batch`` decode slots; requests join as slots free up;
  * chunked prefill: a joining prompt is fed through ``prefill_chunk`` in
    chunks of ``prefill_chunk`` tokens while other slots keep decoding;
  * a token-budget scheduler: decoding slots each emit one token per
    iteration, prefilling slots share ``token_budget - n_decoding`` tokens
    FCFS (``None`` = unmetered);
  * a paged KV cache (``page_size=``): admission gated on free pages,
    page-granular decode growth, and recompute-style preemption of the
    newest request when the pool runs dry;
  * greedy (``argmax``) or temperature sampling from an explicit
    ``torch.Generator``; EOS stops a request and is never emitted.

Left for later slices: the prefix cache, the resilience layer (fault plan,
auditor, degrade ladder), serving-state snapshots and the straggler
detector.

The JAX engine updates its device state through jitted, donated functions;
here the model steps and the slot resets update the state tensors in place.
The engine never drops to the CPU: asking for ``device="cuda"`` on a
machine without a card raises.

Sequence-parallel serving (a bundle whose ``pctx`` has ``sp_degree > 1``):
on the virtual ring one engine holds every rank's shard of the state; on a
process group every rank runs the same engine on the same requests, takes
the same host decisions (admission, block tables, allocator, sampling from
the same replicated logits with the same seed) and holds only its shard of
the cache (its slots of the dense slab, its stripe of pages).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels.ref import PAD_POS
from repro_torch.serving.kv_cache import (
    PageAllocator,
    dense_slot_rows,
    local_pages,
    pages_for,
    sp_ranks,
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
    status: str = "queued"  # queued | running | done
    t_submit: float = 0.0
    t_first: float | None = None
    t_done: float | None = None


class ServingEngine:
    """Continuous-batching engine over a :class:`~repro_torch.models.registry.ModelBundle`.

    Knobs as in the JAX engine: ``max_batch`` / ``max_len`` (slots and
    per-slot capacity), ``prefill_chunk``, ``token_budget``, ``page_size``
    (paged cache; ``None`` keeps the dense slab), ``max_pages`` (pool size,
    default dense-equivalent), ``preempt``.  ``device`` is where the state
    lives and the steps run; ``params`` must already be there.
    """

    def __init__(self, bundle, params, *, max_batch: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0, prefill_chunk: int = 32,
                 token_budget: int | None = None, page_size: int | None = None,
                 max_pages: int | None = None, preempt: bool = True, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine(device='cuda') needs a CUDA device and none is available; "
                "pass device='cpu' to serve on the CPU"
            )
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
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
            self.page_size = page_size
            self.slot_pages = pages_for(max_len, page_size)
            self.cap = self.slot_pages * page_size  # logical per-slot tokens
            self.max_pages = max_pages if max_pages is not None else max_batch * self.slot_pages
            if self.max_pages < 1:
                raise ValueError(f"max_pages must be >= 1, got {self.max_pages}")
            self.NULL = self.max_pages  # unmapped block-table sentinel
            self.alloc = PageAllocator(self.max_pages, stripes=self._sp[0])
            self._bt = np.full((max_batch, self.slot_pages), self.NULL, np.int32)
            self._bt_dirty = False
            self.state = bundle.init_paged_state(
                self.max_pages, page_size, max_batch, self.slot_pages, self.device
            )
            self._step = bundle.decode_step_paged
            self._chunk_step = bundle.prefill_chunk_paged
        else:
            self.page_size = None
            self.cap = max_len
            self.state = bundle.init_serve_state(max_batch, max_len, self.device)
            self._step = bundle.decode_step
            self._chunk_step = bundle.prefill_chunk

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
        }

    # ------------------------------------------------------------- API

    def submit(self, prompt, max_new_tokens=16, eos_id=None) -> Request:
        """Queue a request.  The prompt must fit one slot's capacity;
        generation past capacity is truncated (the request retires at the
        last writable position)."""
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
        req.t_submit = time.perf_counter()
        self.queue.append(req)
        return req

    def run(self, *, max_steps: int = 10_000):
        """Drive until queue and slots drain (or ``max_steps`` iterations):
        each iteration admits, runs one prefill chunk step and one decode
        step."""
        for _ in range(max_steps):
            self._admit()
            if all(s is None for s in self.slots) and not self.queue:
                break
            self._prefill_tick()
            self._decode_once()
        return self.done

    # --------------------------------------------------------- internals

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

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            if not self._admit_into(i, self.queue[0]):
                break  # page exhaustion: strict FCFS, later requests wait

    def _admit_into(self, i, req) -> bool:
        """Admit the queue head into free slot ``i``; False when the page
        pool cannot cover its prompt (the caller defers)."""
        if self._paged:
            need = pages_for(len(req._tokens) - 1, self.page_size)
            fresh = self._alloc_pages(need)
            if fresh is None:
                return False
            req._pages = fresh
            self._bt[i, :] = self.NULL
            self._bt[i, :need] = fresh
            self._bt_dirty = True
        self.queue.pop(0)
        self.slots[i] = req
        req.status = "running"
        self._reset_slot(i)
        req._filled = 0  # prompt tokens already in the cache
        req._cached = 0  # total cache slots written
        if not self._prefilling(req):
            req._next_token = int(req._tokens[-1])  # single-token prompt
        return True

    @torch.inference_mode()
    def _reset_slot(self, i):
        """In-place slot reset.  Paged: only the length (freed pages already
        had their position rows restored on release).  Dense: length and
        the slot's position row."""
        self.state["len"][i] = 0
        if not self._paged:
            self.state["pos"][dense_slot_rows(i, self.max_batch, *self._sp)] = PAD_POS

    def _alloc_pages(self, n):
        if n <= 0:
            return []
        try:
            return self.alloc.alloc(n)
        except MemoryError:
            return None

    def _prefilling(self, req) -> bool:
        return getattr(req, "_filled", 0) < len(req._tokens) - 1

    @torch.inference_mode()
    def _sync_bt(self):
        if self._paged and self._bt_dirty:
            self.state["block_tables"].copy_(torch.from_numpy(self._bt))
            self._bt_dirty = False

    # ---- paged bookkeeping ----------------------------------------------

    @torch.inference_mode()
    def _free_slot_pages(self, i):
        """Return slot ``i``'s pages to the pool, restoring their position
        rows to ``PAD_POS`` so a future owner never attends stale entries."""
        pages = [int(p) for p in self._bt[i] if p != self.NULL]
        if pages:
            self.alloc.free(pages)
            idx = local_pages(torch.tensor(pages, dtype=torch.long, device=self.device),
                              self.max_pages, *self._sp)
            held = idx[idx < self.state["pos"].shape[0]]  # this rank's stripe
            self.state["pos"][held] = PAD_POS
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
        a page boundary, preempting (newest first) when the pool is dry."""
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
            while True:
                try:
                    page = self.alloc.alloc(1)[0]
                except MemoryError:
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
        batched chunk step."""
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
                if self.token_budget is not None:
                    # Metered: this iteration's budget went to the prefill;
                    # the first decode waits one iteration.
                    self._hold_decode.add(i)

    # ---- decode ---------------------------------------------------------

    @torch.inference_mode()
    def _sample(self, logits):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    def _decode_once(self):
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
        mask = np.zeros((self.max_batch,), bool)
        mask[active] = True
        logits, _ = self._step(self.params, torch.from_numpy(toks).to(self.device), self.state,
                               torch.from_numpy(mask).to(self.device))
        self.counters["decode_steps"] += 1
        nxt = self._sample(logits).cpu().numpy()
        now = time.perf_counter()
        for i in active:
            req = self.slots[i]
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
        if self._paged:
            out["pages"] = self.alloc.utilization()
        return out

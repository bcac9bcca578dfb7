"""Serving launcher: batched requests through the continuous-batching engine
(port of ``repro.launch.serve``).

Prompts prefill in chunks of ``--prefill-chunk`` tokens, interleaved with
decode under ``--token-budget``; ``--page-size`` switches to the paged KV
pool with ``--max-pages`` pages and (``--preempt``) recompute preemption.
Runs on the card by default; ``--device cpu`` runs the plain versions on
the CPU.  Like the reference's CLI it serves at SP degree 1 and prints the
planner's modeled link bytes of the serving schedules at SP 4
(:func:`print_serving_plan`); sequence-parallel serving is reached through
the library (``build_model(cfg, ParallelContext(sp_degree=P, ...))`` and
``ServingEngine``).  The prefix cache and the resilience flags of the JAX
launcher come with later slices.

Example (reduced model, paged, on the card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \\
      --requests 16 --max-new 24 --prefill-chunk 16 --token-budget 32 \\
      --page-size 16 --max-pages 24
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.api import ParallelContext
from repro_torch.core.strategies import get_strategy, strategy_cost
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import ServingEngine


def print_serving_plan(cfg, *, max_batch: int, chunk: int, max_len: int, sp_degree: int = 4,
                       page_size: int | None = None):
    """Planner view of the serving schedules for this config: modeled link
    bytes a step at an SP degree of ``sp_degree`` (the ``comm_cost`` models
    that ``plan_decode`` / ``plan_prefill`` attach to their plans).  With
    ``page_size`` the paged block-table term rides along (``table_pages =
    ceil(max_len / page_size)``).  The reference's ``prefix_hit_rate``
    line comes with the prefix cache and the prefill rings."""
    from repro_torch.serving.kv_cache import pages_for

    bpe = 2 if cfg.dtype == "bfloat16" else 4
    table_pages = pages_for(max_len, page_size) if page_size else None
    common = dict(bytes_per_elem=bpe, S_kv=max_len, table_pages=table_pages)
    dec = strategy_cost(get_strategy("decode"), max_batch, 1, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, sp_degree, **common)
    pre = strategy_cost(get_strategy("prefill"), 1, chunk, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, sp_degree, **common)
    paged = f" (paged: +{table_pages}-entry block table/slot)" if page_size else ""
    print(
        f"serving plan @ SP={sp_degree}: decode {dec.max_direction:.0f} B/step "
        f"(batch {max_batch}), prefill {pre.max_direction:.0f} B/chunk "
        f"(chunk {chunk}) \u2014 cache-resident, independent of context length"
        f"{paged}"
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens per chunked-prefill step")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="prefill tokens per iteration are capped at this minus the "
                    "number of decoding slots")
    ap.add_argument("--page-size", type=int, default=None,
                    help="enable the paged KV cache with this many tokens per page")
    ap.add_argument("--max-pages", type=int, default=None,
                    help="page-pool size (default: max_batch * ceil(max_len/page_size))")
    ap.add_argument("--preempt", action=argparse.BooleanOptionalAction, default=True,
                    help="evict the newest request when the page pool runs dry")
    ap.add_argument("--impl", default="auto", choices=("auto", "cuda", "torch"),
                    help="attention impl: cuda runs the hand-written kernels, torch the "
                    "plain versions, auto picks by the tensors' device")
    ap.add_argument("--block-k-decode", type=int, default=None,
                    help="KV tile of the plain decode path")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device; pass --device cpu to run on the CPU")
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    pctx = ParallelContext(impl=args.impl, block_k_decode=args.block_k_decode,
                           device=args.device)
    bundle = build_model(cfg, pctx)
    params = bundle.init(args.seed)
    print_serving_plan(cfg, max_batch=args.max_batch, chunk=args.prefill_chunk,
                       max_len=args.max_len, page_size=args.page_size)
    eng = ServingEngine(
        bundle, params, max_batch=args.max_batch, max_len=args.max_len,
        temperature=args.temperature, seed=args.seed, prefill_chunk=args.prefill_chunk,
        token_budget=args.token_budget, page_size=args.page_size, max_pages=args.max_pages,
        preempt=args.preempt, device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(3, 9))).astype(np.int32)
        eng.submit(prompt, max_new_tokens=args.max_new)
    done = eng.run()
    dt = time.perf_counter() - t0
    s = eng.stats()
    print(
        f"served {s['requests']} requests, {s['tokens']} tokens in {dt:.2f}s "
        f"({s['tokens']/dt:.1f} tok/s) mean_latency {s['mean_latency_s']*1e3:.0f} ms "
        f"mean_ttft {s['mean_ttft_s']*1e3:.0f} ms on {args.device}"
    )
    print(f"steps: {s['decode_steps']} decode, {s['prefill_steps']} prefill chunks "
          f"({s['prefill_tokens']} prompt tokens)")
    if "pages" in s:
        u = s["pages"]
        print(f"pages: {u['high_water']}/{u['pages_total']} high-water "
              f"(x{args.page_size} tokens), {s['preemptions']} preemptions")
    for r in done[:3]:
        print(f"  req {r.uid}: prompt {r.prompt.tolist()} -> {r.output}")
    return s


if __name__ == "__main__":
    main()

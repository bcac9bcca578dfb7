"""Training launcher (port of ``repro.launch.train``): synthetic data, the
``Trainer``, AdamW, at any sequence-parallel degree.

Runs on the card by default; ``--device cpu`` runs the plain versions on the
CPU.  ``--sp-degree P`` trains through the chosen ring strategy on the
virtual ring of P ranks (one process, one device; the batch is laid out in
zigzag order for P).  The JAX launcher's ``--ckpt``/``--ckpt-every``
(checkpoint manager) and ``--fail-at`` (fault-tolerant runner) wait for
their modules.

Example (reduced model on the CPU, TokenRing over 4 virtual ranks):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 20 --batch 4 --seq 128 --sp-degree 4 --strategy tokenring
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.api import ParallelContext
from repro_torch.core.strategies import available_strategies, get_strategy
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig, n_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="auto", choices=("auto", "cuda", "torch"),
                    help="attention impl, forward and backward: cuda runs the hand-written "
                    "kernels, torch the plain versions, auto picks by the tensors' device")
    ap.add_argument("--block-q", type=int, default=512)
    ap.add_argument("--block-k", type=int, default=512)
    ap.add_argument("--block-q-bwd", type=int, default=None,
                    help="backward Q tile of the plain version (default: --block-q)")
    ap.add_argument("--block-k-bwd", type=int, default=None,
                    help="backward KV tile of the plain version (default: --block-k)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--sp-degree", type=int, default=1,
                    help="ranks of the virtual sequence-parallel ring")
    ap.add_argument("--strategy", default="tokenring",
                    choices=("auto", *(n for n in available_strategies()
                                       if not get_strategy(n).serving_side)),
                    help="SP strategy (auto = the cost models' choice)")
    ap.add_argument("--travel-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="wire format of TokenRing's travelling accumulator")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run each ring send after the step's computes (same values)")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device; pass --device cpu to run on the CPU")
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    pctx = ParallelContext(impl=args.impl, block_q=args.block_q, block_k=args.block_k,
                           block_q_bwd=args.block_q_bwd, block_k_bwd=args.block_k_bwd,
                           device=args.device, sp_degree=args.sp_degree,
                           strategy=args.strategy, layout=cfg.layout,
                           travel_dtype=args.travel_dtype, overlap=not args.no_overlap)
    bundle = build_model(cfg, pctx)
    tcfg = TrainerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                         total_steps=args.steps, microbatches=args.microbatches,
                         opt=AdamWConfig())
    trainer = Trainer(bundle, tcfg)
    data = SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
        layout=cfg.layout, sp_degree=pctx.sp_degree))
    state = trainer.init_state(args.seed)
    sp = (f", {args.strategy} over {args.sp_degree} virtual ranks" if args.sp_degree > 1
          else "")
    print(f"{cfg.name}: {n_params(state['params']) / 1e6:.1f}M parameters, batch "
          f"{args.batch} x seq {args.seq}, remat {cfg.remat}, on {args.device}{sp}")
    state, hist = trainer.run(state, data, steps=args.steps)
    tail = trainer.step_seconds[1:] or trainer.step_seconds
    step_s = float(np.median(tail))
    print(f"final step {int(state['step'])}  loss {hist[-1]:.4f} (start {hist[0]:.4f}); "
          f"median step {step_s * 1e3:.0f} ms, {args.batch * args.seq / step_s:.0f} tok/s")
    return hist


if __name__ == "__main__":
    main()

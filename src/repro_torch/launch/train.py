"""Training launcher (port of ``repro.launch.train``): synthetic data, the
``Trainer``, AdamW, at sequence-parallel degree 1.

Runs on the card by default; ``--device cpu`` runs the plain versions on the
CPU.  The JAX launcher's ``--ckpt``/``--ckpt-every`` (checkpoint manager),
``--fail-at`` (fault-tolerant runner) and ``--strategy`` (the ring) wait for
their modules.

Example (reduced model on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 20 --batch 4 --seq 128
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.core.api import ParallelContext
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
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device; pass --device cpu to run on the CPU")
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    pctx = ParallelContext(impl=args.impl, block_q=args.block_q, block_k=args.block_k,
                           block_q_bwd=args.block_q_bwd, block_k_bwd=args.block_k_bwd,
                           device=args.device)
    bundle = build_model(cfg, pctx)
    tcfg = TrainerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                         total_steps=args.steps, microbatches=args.microbatches,
                         opt=AdamWConfig())
    trainer = Trainer(bundle, tcfg)
    data = SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
        layout=cfg.layout, sp_degree=pctx.sp_degree))
    state = trainer.init_state(args.seed)
    print(f"{cfg.name}: {n_params(state['params']) / 1e6:.1f}M parameters, batch "
          f"{args.batch} x seq {args.seq}, remat {cfg.remat}, on {args.device}")
    state, hist = trainer.run(state, data, steps=args.steps)
    tail = trainer.step_seconds[1:] or trainer.step_seconds
    step_s = float(np.median(tail))
    print(f"final step {int(state['step'])}  loss {hist[-1]:.4f} (start {hist[0]:.4f}); "
          f"median step {step_s * 1e3:.0f} ms, {args.batch * args.seq / step_s:.0f} tok/s")
    return hist


if __name__ == "__main__":
    main()

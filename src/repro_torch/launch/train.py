"""Training launcher (port of ``repro.launch.train``): synthetic data, the
``Trainer``, AdamW, at any sequence-parallel degree.

Runs on the card by default; ``--device cpu`` runs the plain versions on the
CPU.  ``--sp-degree P`` trains through the chosen ring strategy on the
virtual ring of P ranks (one process, one device; the batch is laid out in
the config's layout: zigzag for attention, contiguous for falcon-mamba,
whose layers run the sequence-parallel scan, ``core.api.sp_scan``, in
place of a ring strategy, and for recurrentgemma, whose windowed layers
take the window halo and its recurrent layers the scan); ``--pods N``
factors those ranks as N pods and trains through the paper's multi-pod hybrid (an inter-pod KV ring outside,
``--strategy`` inside each pod).  ``--ckpt DIR`` checkpoints every ``--ckpt-every``
steps and runs through the fault-tolerant runner, which restores the
latest checkpoint after a failure (``--fail-at`` injects one).

Example (reduced model on the CPU, TokenRing over 4 virtual ranks):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 20 --batch 4 --seq 128 --sp-degree 4 --strategy tokenring

Example (the hybrid: 2 pods of 2 ranks, TokenRing inside each pod):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 20 --batch 4 --seq 128 --sp-degree 4 --pods 2 --strategy tokenring

Example (falcon-mamba reduced: the chunked selective scan over 4 virtual
ranks, the sequence sharded contiguously; ``--strategy`` does not apply):
  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 128 --sp-degree 4

Example (recurrentgemma reduced: its local attention through the window
halo, its RG-LRU through the scan, the conv's halo on a process group;
``--strategy`` does not apply to windowed layers):
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --reduced --device cpu --steps 20 --batch 4 --seq 128 --sp-degree 4

Example (data parallelism with FSDP storage: 2 data ranks x TokenRing over
4 virtual ranks, the virtual (data 2, model 4) mesh; ``--data-degree`` D
times ``--sp-degree`` ranks, the parameters and AdamW moments stored by the
ZeRO-3 rules, ``repro_torch.sharding``; each layer gathered just in time
inside its remat region, the banner giving the bytes gathered at once
beside the whole tree's):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --steps 20 --batch 4 --seq 128 --data-degree 2 --sp-degree 4

Example (checkpoints every 5 steps, a failure injected at step 7):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
      --steps 12 --batch 4 --seq 128 --ckpt build/ckpt --ckpt-every 5 --fail-at 7
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
from repro_torch.runtime.fault_tolerance import FailureInjector, FaultTolerantRunner
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
    ap.add_argument("--ckpt", default=None, help="checkpoint directory (fault-tolerant run)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (fault-tolerance demo)")
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
    ap.add_argument("--data-degree", type=int, default=1,
                    help="data ranks: D x --sp-degree ranks form the virtual (data, model) "
                    "mesh; FSDP storage is on whenever D > 1 (the reference's layout)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods of the ring: with N > 1 the multi-pod hybrid (inter-pod KV "
                    "ring x --strategy inside each pod of sp-degree/N ranks)")
    # window-only strategies need a window= the full-attention layers of a
    # training run never pass, serving-side schedules (decode / prefill) only
    # run against a resident cache, and two-axis rings are planned via
    # plan(topology=...); none of them is offered
    ap.add_argument("--strategy", default="tokenring",
                    choices=("auto", *(n for n in available_strategies()
                                       if not get_strategy(n).requires_window
                                       and not get_strategy(n).serving_side
                                       and get_strategy(n).ring_axes == 1)),
                    help="SP strategy (auto = the cost models' choice); the inner one with "
                    "--pods")
    ap.add_argument("--travel-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="wire format of TokenRing's travelling accumulator")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run each ring send to its end before the step's computes "
                    "(nothing overlaps; the same values)")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device; pass --device cpu to run on the CPU")
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    pctx = ParallelContext(impl=args.impl, block_q=args.block_q, block_k=args.block_k,
                           block_q_bwd=args.block_q_bwd, block_k_bwd=args.block_k_bwd,
                           device=args.device, sp_degree=args.sp_degree, pods=args.pods,
                           data_degree=args.data_degree,
                           strategy=args.strategy, layout=cfg.layout,
                           travel_dtype=args.travel_dtype, overlap=not args.no_overlap)
    bundle = build_model(cfg, pctx)
    tcfg = TrainerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                         total_steps=args.steps, microbatches=args.microbatches,
                         checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt,
                         opt=AdamWConfig())
    inj = FailureInjector([args.fail_at]) if args.fail_at is not None else None
    trainer = Trainer(bundle, tcfg, step_hook=inj)
    data = SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
        layout=cfg.layout, sp_degree=pctx.sp_degree))
    sp_path = {"ssm": "the chunked scan",
               "hybrid": "the window halo and the scan"}.get(cfg.family, args.strategy)
    sp = (f", {sp_path} over {args.sp_degree} virtual ranks" if args.sp_degree > 1
          else "")
    if args.pods > 1:
        sp += f" ({args.pods} pods, an inter-pod KV ring outside)"
    if args.data_degree > 1:
        sp += (f"; {args.data_degree} data ranks, FSDP storage on the "
               f"{dict(pctx.mesh.shape)} mesh")

    def banner(state):
        n = n_params(trainer.full_params(state))
        print(f"{cfg.name}: {n / 1e6:.1f}M parameters, batch "
              f"{args.batch} x seq {args.seq}, remat {cfg.remat}, on {args.device}{sp}")
        if trainer.comm is not None:
            from repro_torch.sharding import fsdp_gathered_bytes, tree_bytes

            layout = trainer.params_layout
            print(f"FSDP: each layer gathered just in time inside its remat region: "
                  f"{fsdp_gathered_bytes(layout) / 1e6:.1f} MB gathered at once under remat, "
                  f"the whole tree {tree_bytes(layout.meta) / 1e6:.1f} MB")

    if args.ckpt:
        runner = FaultTolerantRunner(trainer, max_restarts=3)
        state, hist = runner.run(args.seed, data, steps=args.steps)
        banner(state)
        print(f"checkpoints under {args.ckpt}: latest step {trainer.ckpt.latest_step()}, "
              f"{runner.restarts} restart(s)")
    else:
        state = trainer.init_state(args.seed)
        banner(state)
        state, hist = trainer.run(state, data, steps=args.steps)
    tail = trainer.step_seconds[1:] or trainer.step_seconds
    step_s = float(np.median(tail))
    print(f"final step {int(state['step'])}  loss {hist[-1]:.4f} (start {hist[0]:.4f}); "
          f"median step {step_s * 1e3:.0f} ms, {args.batch * args.seq / step_s:.0f} tok/s")
    return hist


if __name__ == "__main__":
    main()

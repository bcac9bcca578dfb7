"""Multi-rank substrate checks (port of ``repro.testing.distributed_check``):
compressed psum, elastic resharding, cross-mesh checkpoint restore.

    PYTHONPATH=src python -m repro_torch.testing.distributed_check [compress|elastic|ckpt_mesh]
    PYTHONPATH=src python -m repro_torch.testing.distributed_check --virtual [--device cpu]

By default it spawns 8 gloo ranks on the CPU, each running
every check on its own blocks; ``--virtual`` runs the virtual mesh (every
rank in this process) on ``--device`` (the card by default).  It prints
the reference's ``PASS`` lines, then ``ALL CHECKS PASSED``, and exits
non-zero if a check fails.  ``train_ft`` (by name, with ``--virtual``) is
the port of ``examples/train_distributed_ft.py``'s run: a reduced qwen3 on
the virtual (data 2, model 4) mesh through TokenRing with FSDP storage,
checkpoints every 10 steps, a failure at step 17 and one restart.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.elastic import reshard, shrink_mesh
from repro_torch.sharding import (
    assemble_blocks,
    block_index,
    cut_blocks,
    layout_for,
    shard_tree,
    spec_leaves,
    unshard_tree,
)

N_RANKS = 8


def _same(a, b, what):
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: not bitwise equal")


def _close(got, want, atol, what):
    err = float(np.max(np.abs(got - want)))
    if not err <= atol:
        raise AssertionError(f"{what}: max error {err:.3e} above {atol:.3e}")


def _my_blocks(full, layout, what):
    """Hold this rank's blocks (``layout.rank``; every block with ``None``)
    against the cut of the full tree."""
    for x, f, s in zip(tree_leaves(full["blocks"]), tree_leaves(full["tree"]),
                       spec_leaves(layout.specs)):
        want = cut_blocks(f, s, layout.mesh)
        if layout.rank is not None:
            i = block_index(s, layout.mesh, layout.rank)
            want = want[i:i + 1]
        _same(x, want, what)


def check_compressed_psum(ctx):
    from repro_torch.optim.compress import compressed_psum_ef

    rng = np.random.default_rng(0)
    g_all = rng.standard_normal((N_RANKS, 64)).astype(np.float32)  # a row a rank
    exact_mean = g_all.mean(axis=0)
    axis, rows = ctx.data_view(Mesh(("data",), (N_RANKS,)))
    g = torch.from_numpy(g_all[rows]).to(ctx.device)
    e = torch.zeros_like(g)

    def step(e):
        out, new_e = compressed_psum_ef({"w": g}, {"w": e}, axis=axis)
        return out["w"][0].cpu().numpy(), new_e["w"]

    # one step: the quantized mean is close to the exact one
    got, e = step(e)
    scale = np.abs(g_all).max() / 127.0
    _close(got, exact_mean, scale + 1e-6, "one step")
    # with error feedback the mean of the transmitted means tends to the exact one
    acc = np.zeros(64, np.float32)
    n = 30
    for _ in range(n):
        got, e = step(e)
        acc += got
    _close(acc / n, exact_mean, scale / 4 + 1e-6, "30 steps")
    ctx.say("PASS compressed psum (int8 + error feedback, 8-way)")


def check_elastic_reshard(ctx):
    mesh8 = shrink_mesh(N_RANKS, model_axis=4)
    assert mesh8.shape == {"data": 2, "model": 4}, mesh8
    params = {
        "layers": [{"w": torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)}],
        "embed": {"table": torch.arange(32 * 4, dtype=torch.float32).reshape(32, 4)},
    }
    lay8 = layout_for(params, mesh8, rank=ctx.rank)
    p8 = shard_tree(params, lay8)
    _my_blocks({"blocks": p8, "tree": params}, lay8, "(2, 4) blocks")
    # lose half the ranks -> a (1, 4) mesh; every old rank takes part in the
    # gather, the survivors cut their new blocks
    mesh4 = shrink_mesh(4, model_axis=4)
    assert mesh4.shape == {"data": 1, "model": 4}, mesh4
    survivor = ctx.rank is None or ctx.rank < 4
    p4, lay4 = reshard(p8, lay8, mesh4, rank=ctx.rank if survivor else None,
                       comm=ctx.comm(mesh8))
    if survivor:
        _my_blocks({"blocks": p4, "tree": params}, lay4, "(1, 4) blocks after the move")
        if ctx.rank is None:
            for a, b in zip(tree_leaves(params), tree_leaves(unshard_tree(p4, lay4))):
                _same(a, b, "(1, 4) gathered")
    # 3 ranks: the policy maximizes the ranks used, shrinking the model axis
    # as needed (SP degree 1 = plain DP is still a valid config)
    mesh3 = shrink_mesh(3, model_axis=4)
    assert mesh3.shape == {"data": 3, "model": 1}, mesh3
    if ctx.rank is None:
        p3, lay3 = reshard(p4, lay4, mesh3)
        _my_blocks({"blocks": p3, "tree": params}, lay3, "(3, 1) blocks")
    ctx.say("PASS elastic reshard (8 -> 4 -> 3 devices)")


def check_checkpoint_cross_mesh(ctx):
    from repro_torch.checkpoint.manager import CheckpointManager

    mesh_a = shrink_mesh(N_RANKS, model_axis=4)  # (2, 4)
    tree = {"w": torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)}
    lay_a = layout_for(tree, mesh_a, rank=ctx.rank)
    tree_a = shard_tree(tree, lay_a)
    d = ctx.scratch("ckpt_mesh")
    mgr = CheckpointManager(d, keep=1, group=ctx.group)
    mgr.save(1, tree_a, layout=lay_a)
    # restore onto a DIFFERENT mesh shape
    mesh_b = shrink_mesh(N_RANKS, model_axis=2)  # (4, 2)
    lay_b = layout_for(tree, mesh_b, rank=ctx.rank)
    template = shard_tree({"w": torch.zeros_like(tree["w"])}, lay_b)
    restored = mgr.restore(1, template, layout=lay_b)
    _my_blocks({"blocks": restored, "tree": tree}, lay_b, "restored (4, 2) blocks")
    if ctx.rank is None:
        _same(assemble_blocks(restored["w"], lay_b.specs["w"], mesh_b), tree["w"], "restored")
    assert lay_b.mesh.shape["model"] == 2
    ctx.say("PASS checkpoint restore across meshes (2x4 -> 4x2)")


def train_distributed_ft(device="cpu", steps=25, fail_at=17, log=print):
    """``examples/train_distributed_ft.py``'s run on the virtual (2, 4)
    mesh: returns ``(state, history, restarts)``."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.fault_tolerance import FailureInjector, FaultTolerantRunner
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    pctx = ParallelContext(data_degree=2, sp_degree=4, strategy="tokenring", impl="auto",
                           block_q=64, block_k=64, device=device)
    cfg = ARCHS["qwen3-1.7b"].reduced(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        vocab_size=256, logits_chunk=32)
    bundle = build_model(cfg, pctx)
    data = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                            global_batch=8, seed=1, layout="zigzag",
                                            sp_degree=pctx.sp_degree))
    with tempfile.TemporaryDirectory() as ckdir:
        tcfg = TrainerConfig(lr=2e-3, warmup_steps=3, total_steps=steps, checkpoint_every=10,
                             checkpoint_dir=ckdir, async_checkpoint=False)
        trainer = Trainer(bundle, tcfg, step_hook=FailureInjector(at_steps=[fail_at]))
        runner = FaultTolerantRunner(trainer, max_restarts=2, log=log)
        state, hist = runner.run(0, data, steps=steps)
    log(f"completed {int(state['step'])} steps with {runner.restarts} restart(s); loss "
        f"{hist[0]:.3f} -> {hist[-1]:.3f}")
    specs = sorted({str(s) for s in spec_leaves(trainer.params_layout.specs)})
    log(f"weight sharding specs in use: {specs[:4]} ...")
    return state, hist, runner.restarts


def check_train_ft(ctx):
    if ctx.rank is not None:
        raise SystemExit("train_ft runs on the virtual mesh: pass --virtual")
    _, hist, restarts = train_distributed_ft(ctx.device, log=ctx.say)
    assert hist[-1] < hist[0], "loss must decrease"
    assert restarts == 1
    ctx.say("OK: distributed train + failure + restore-from-checkpoint")


CHECKS = {
    "compress": check_compressed_psum,
    "elastic": check_elastic_reshard,
    "ckpt_mesh": check_checkpoint_cross_mesh,
}
EXTRA = {"train_ft": check_train_ft}


class _Virtual:
    """Every rank in this process (the virtual mesh)."""

    rank = group = None

    def __init__(self, device, root):
        self.device, self.root = torch.device(device), root

    def say(self, msg):
        print(msg, flush=True)

    def data_view(self, mesh):
        from repro_torch.core.collectives import VirtualRing

        return VirtualRing(mesh.size, self.device, link_class="data"), slice(None)

    def comm(self, mesh):
        return None

    def scratch(self, name):
        return os.path.join(self.root, name)


class _Rank:
    """One gloo rank of ``N_RANKS``."""

    def __init__(self, rank, root):
        import torch.distributed as dist

        self.rank, self.root, self.device = rank, root, torch.device("cpu")
        self.group = dist.group.WORLD
        self._comms = {}

    def say(self, msg):
        if self.rank == 0:
            print(msg, flush=True)

    def comm(self, mesh):
        from repro_torch.core.collectives import ProcessGroupMeshComm

        if mesh not in self._comms:
            self._comms[mesh] = ProcessGroupMeshComm(mesh, self.group)
        return self._comms[mesh]

    def data_view(self, mesh):
        return self.comm(mesh).view(("data",), "data"), slice(self.rank, self.rank + 1)

    def scratch(self, name):
        return os.path.join(self.root, name)


def _rank_main(rank, n, root, names):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(root, 'rendezvous')}",
                            world_size=n, rank=rank)
    try:
        ctx = _Rank(rank, root)
        for name in names:
            CHECKS[name](ctx)
            dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checks", nargs="*", choices=[*CHECKS, *EXTRA])
    ap.add_argument("--virtual", action="store_true",
                    help="the virtual mesh: every rank in this process, on --device")
    ap.add_argument("--device", default="cuda", help="the virtual mesh's device")
    args = ap.parse_args(argv)
    names = args.checks or list(CHECKS)
    with tempfile.TemporaryDirectory() as root:
        if args.virtual:
            if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
                raise SystemExit("--device cuda needs a CUDA device; pass --device cpu")
            ctx = _Virtual(args.device, root)
            for name in names:
                {**CHECKS, **EXTRA}[name](ctx)
        else:
            bad = [n for n in names if n in EXTRA]
            if bad:
                raise SystemExit(f"{bad} run on the virtual mesh: pass --virtual")
            import torch.multiprocessing as mp

            mp.spawn(_rank_main, args=(N_RANKS, root, names), nprocs=N_RANKS, join=True)
    print("ALL CHECKS PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The dry run's process-group cases (``test_torch_dryrun.py``), in a
process of their own: ``init_process_group`` holds one group a process.

1. The mini direction accounting (the port of ``repro.testing.dryrun_check``):
   a reduced qwen3-1.7b's forward pass (the loss, no gradient; head dim 32,
   the kernels' least, where the reference's check takes 16) traced on
   rank 0 of a fake (2, 4) group under Ring and under TokenRing; the ring
   ledger's ``"link"`` bytes a direction.
2. ``run_cell("qwen3-1.7b", "train_4k", multi_pod=False)`` at full size on a
   fake group of 256 ranks: its status, attention calls and memory, and the
   seconds it took.

Writes one JSON object to the path given.  Imports torch and the port only.
"""

import json
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_pctx
from repro_torch.launch.train_step import step_loss
from repro_torch.models.config import ShapeConfig
from repro_torch.models.registry import build_model


def mini_links(strategy: str) -> dict:
    """The reduced model's forward pass on rank 0 of a fake (2, 4) group:
    the ring ledger's link bytes a direction."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.step_analysis import StepAnalysis
    from repro_torch.sharding import layout_for, shard_tree

    mesh = Mesh(("data", "model"), (2, 4))
    dryrun.fake_world(mesh.size)
    cfg = ARCHS["qwen3-1.7b"].reduced(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                                      d_head=32, d_ff=256, vocab_size=256, logits_chunk=64,
                                      remat="full", dtype="float32")
    shape = ShapeConfig("mini", 512, 8, "train")
    pctx = make_pctx(mesh, strategy=strategy, layout=cfg.layout, global_batch=8,
                     block_q=64, block_k=64, device="cpu", ring=dist.group.WORLD)
    bundle = build_model(cfg, pctx)
    meta = dryrun.meta_params(cfg, training=True)
    layout = layout_for(meta, mesh, rank=0)
    blocks = shard_tree(meta, layout)
    batch_blocks = dryrun._batch_blocks(cfg, shape, pctx, "train")
    analysis = StepAnalysis(ledger=pctx.storage.ledger,
                            seq_blocks=dryrun._seq_blocks(cfg, shape, pctx))
    with FakeTensorMode():
        params = dryrun._empty_like_tree(blocks, "cpu")
        batch = {}
        for name, (shp, dt, value) in batch_blocks.items():
            batch[name] = torch.empty(shp, dtype=dt)
            if value is not None:
                analysis.shadow(batch[name], value)
        pctx.storage.ledger.reset()
        with analysis, torch.no_grad():
            step_loss(bundle, layout)(params, batch)
    link = pctx.storage.ledger.class_bytes.get("link", {"fwd": 0.0, "bwd": 0.0})
    return {"fwd": link["fwd"], "bwd": link["bwd"],
            "unresolved": analysis.stats.attention_calls_unresolved,
            "attention_flops": analysis.stats.attention_flops,
            "attention_flops_full": analysis.stats.attention_flops_full}


def main(out: str):
    res = {"ring": mini_links("ring"), "tokenring": mini_links("tokenring")}
    t0 = time.perf_counter()
    rec = dryrun.run_cell("qwen3-1.7b", "train_4k", multi_pod=False, strategy="tokenring",
                          out_dir=out + ".cells", force=True)
    res["cell"] = {"status": rec["status"], "seconds": time.perf_counter() - t0,
                   "world": rec["world"], "memory": rec["memory"],
                   "stats": rec["step_stats_per_device"], "roofline": rec["roofline"],
                   "plan": rec["plan"], "params_total": rec["params_total"]}
    res["sweep"] = list(dryrun.ASSIGNED)
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    print("DRYRUN WORKER DONE")


if __name__ == "__main__":
    main(sys.argv[1])

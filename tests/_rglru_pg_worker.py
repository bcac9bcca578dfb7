"""One rank of the process-group check of recurrentgemma
(``test_torch_rglru.py``): gloo on the CPU, this rank's contiguous shard of
the batch.  The reduced model's loss runs the conv's halo from the previous
rank, the window halo (``core/window.py``) and the RG-LRU's scan over the
group; the rank writes its loss, its token count and the gradients of its
summed loss (``loss * tokens``) to ``out``.  Imports torch, numpy and the
port only."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.core.api import ParallelContext
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves


def _named(tree, name="params"):
    """Leaf names in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _named(tree[key], f"{name}.{key}")]
    if isinstance(tree, list):
        return [x for l, sub in enumerate(tree) for x in _named(sub, f"{name}[{l}]")]
    return [name]


def run(rank: int, P: int, init_file: str, data_dir: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=P)
    try:
        cfg = ARCHS["recurrentgemma-2b"].reduced()
        pctx = ParallelContext(device="cpu", impl="torch", sp_degree=P, layout=cfg.layout,
                               ring=dist.group.WORLD)
        bundle = build_model(cfg, pctx)
        params = torch.load(f"{data_dir}/params.pt")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {}
        for key, a in np.load(f"{data_dir}/batch.npz").items():
            S = a.shape[1] // P
            batch[key] = torch.from_numpy(np.ascontiguousarray(a[:, rank * S:(rank + 1) * S]))
        loss, m = bundle.loss(params, batch)
        grads = torch.autograd.grad(loss * m["tokens"], leaves)
        res = {"loss": loss.detach().numpy(), "denom": m["tokens"].detach().numpy(),
               "halo_bytes": np.float64(pctx.ring.link_bytes["fwd"])}
        for name, g in zip(_named(params), grads):
            res["grad/" + name] = g.numpy()
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()

"""One rank of the process-group checks of the sequence-parallel scan and of
falcon-mamba (``test_torch_mamba.py``): gloo on the CPU, this rank's
contiguous shard of every input.

* ``sp_scan`` of ``a``/``b`` on the flat ring of the group and on the same
  group as 2 pods of 2 (pod-major rank order): ``h`` and the gradients of
  ``sum(h * w)``;
* the reduced falcon-mamba loss through the scan: the rank's loss, its
  token count and the gradients of its summed loss (``loss * tokens``).

Writes everything to ``out``.  Imports torch, numpy and the port only."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.core.api import ParallelContext, sp_scan
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves


def _named(tree, name="params"):
    """Leaf names in ``tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _named(tree[key], f"{name}.{key}")]
    if isinstance(tree, list):
        return [x for l, sub in enumerate(tree) for x in _named(sub, f"{name}[{l}]")]
    return [name]


def _shard(a, rank, P, axis=1):
    S = a.shape[axis] // P
    return torch.from_numpy(np.ascontiguousarray(np.take(a, range(rank * S, (rank + 1) * S),
                                                         axis=axis)))


def run(rank: int, P: int, init_file: str, data_dir: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=P)
    try:
        res = {}
        scan = np.load(f"{data_dir}/scan.npz")
        for pods in (1, 2):
            pctx = ParallelContext(device="cpu", impl="torch", sp_degree=P, pods=pods,
                                   ring=dist.group.WORLD)
            a = _shard(scan["a"], rank, P).requires_grad_(True)
            b = _shard(scan["b"], rank, P).requires_grad_(True)
            h = sp_scan(a, b, pctx=pctx)
            ga, gb = torch.autograd.grad((h * _shard(scan["w"], rank, P)).sum(), [a, b])
            res[f"scan{pods}/h"], res[f"scan{pods}/ga"] = h.detach().numpy(), ga.numpy()
            res[f"scan{pods}/gb"] = gb.numpy()
            res[f"scan{pods}/link_fwd"] = pctx.ring.link_bytes["fwd"]
            res[f"scan{pods}/link_bwd"] = pctx.ring.link_bytes["bwd"]

        cfg = ARCHS["falcon-mamba-7b"].reduced(vocab_size=97)
        pctx = ParallelContext(device="cpu", impl="torch", sp_degree=P, ring=dist.group.WORLD)
        bundle = build_model(cfg, pctx)
        params = torch.load(f"{data_dir}/params.pt")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {key: _shard(a, rank, P) for key, a in np.load(f"{data_dir}/batch.npz").items()}
        loss, m = bundle.loss(params, batch)
        grads = torch.autograd.grad(loss * m["tokens"], leaves)
        res["loss"], res["denom"] = loss.detach().numpy(), m["tokens"].detach().numpy()
        for name, g in zip(_named(params), grads):
            res["grad/" + name] = g.numpy()
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()

"""One rank of the process-group MoE check (``test_torch_moe.py``): gloo on
the CPU, the expert-parallel paths of ``models.moe`` on this rank's share
of every case of :data:`_moe_jax_oracle.CASES` at this SP degree.  Imports
torch, numpy and the port only (the oracle module's helpers are numpy)."""

import numpy as np
import torch
import torch.distributed as dist
from _moe_jax_oracle import CASES, flat_leaves, inputs, moe_config, params_tree

from repro_torch.core.api import ParallelContext
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import moe_ffn


def run(rank: int, P: int, init_file: str, oracle: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=P)
    try:
        want = np.load(oracle)
        res = {}
        for case, (Pc, pods, *_) in CASES.items():
            if Pc != P:
                continue
            cfg = moe_config(ArchConfig, case)
            pctx = ParallelContext(device="cpu", impl="torch", sp_degree=P, pods=pods,
                                   ring=dist.group.WORLD)
            params = _tensors(params_tree(want, f"{case}/param/"))
            names, leaves = zip(*flat_leaves(params))

            # training: this rank's contiguous shard, the aux taken once over
            # the ranks (each rank's loss carries aux / P)
            x, w = inputs(case, "a2a")
            S_loc = x.shape[1] // P
            rows = slice(rank * S_loc, (rank + 1) * S_loc)
            xs = torch.from_numpy(np.ascontiguousarray(x[:, rows])).requires_grad_(True)
            y, aux = moe_ffn(params, xs, cfg, pctx, sharded=True)
            loss = (y * torch.from_numpy(np.ascontiguousarray(w[:, rows]))).sum() + aux / P
            grads = torch.autograd.grad(loss, [xs, *leaves])
            res[f"{case}/a2a/y"], res[f"{case}/a2a/aux"] = _np(y), _np(aux)
            res[f"{case}/a2a/gx"] = _np(grads[0])
            for name, g in zip(names, grads[1:]):
                res[f"{case}/a2a/grad/{name}"] = _np(g)
            # serving: the replicated tokens, each rank routing its slice
            with torch.no_grad():
                y, _ = moe_ffn(params, torch.from_numpy(x), cfg, pctx)
            res[f"{case}/a2a_replicated/y"] = _np(y)

            # decode: one token a row, replicated; each rank's copy of
            # sum(y * w) is taken once over the ranks
            x, w = inputs(case, "decode")
            xd = torch.from_numpy(x).requires_grad_(True)
            y, aux = moe_ffn(params, xd, cfg, pctx)
            loss = (y * torch.from_numpy(w)).sum() / P + aux
            grads = torch.autograd.grad(loss, [xd, *leaves])
            res[f"{case}/decode/y"] = _np(y)
            res[f"{case}/decode/gx"] = _np(grads[0])
            for name, g in zip(names, grads[1:]):
                res[f"{case}/decode/grad/{name}"] = _np(g)
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict) else torch.from_numpy(v.copy()).requires_grad_()
            for k, v in tree.items()}


def _np(t):
    return t.detach().numpy()

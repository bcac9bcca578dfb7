"""One rank of the data-parallel checks on a gloo group of data 2 x model 2
(``test_torch_data_parallel.py``): the ``Trainer`` with FSDP storage over
the group, each rank holding its (data, sequence) block of the batch and
its blocks of the parameters and moments.

For each case ``(key, arch, overrides, clip norm, data config)``: three
steps from the full parameters in ``<data_dir>/<key>.pt`` (the ring in the
data's sequence layout), each step's loss, global norm and clip scale, the
data-axis bytes the rank's ledger counted, and the gathered parameters
after them (rank 0 writes them to ``out``, under ``key``).

``run_vlm``: reduced pixtral-12b's loss and gradients on a group of data
``data`` x model ``world / data``, one step's ``value_and_grad`` of the
``Trainer``'s loss (its blocks gathered, each rank's loss weighted by its
share of the tokens) on each batch ``<data_dir>/<key>.npz``, the gradients
gathered to full tensors.  Imports torch, numpy and the port only."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.core.api import ParallelContext
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from repro_torch.launch.mesh import data_mesh
from repro_torch.launch.train_step import value_and_grad
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.runtime.trainer import Trainer, TrainerConfig, batch_to_device
from repro_torch.sharding import unshard_tree


def run(rank: int, world: int, init_file: str, data_dir: str, out: str, cases,
        steps: int = 3):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        res = {}
        for key, arch, over, clip, data_cfg in cases:
            pctx = ParallelContext(device="cpu", impl="torch", data_degree=2,
                                   sp_degree=world // 2, ring=dist.group.WORLD,
                                   layout=data_cfg["layout"])
            trainer = Trainer(build_model(ARCHS[arch].reduced(**over), pctx), TrainerConfig(
                lr=1e-3, warmup_steps=1, total_steps=steps, opt=AdamWConfig(clip_norm=clip)))
            state = trainer.state_from_params(torch.load(f"{data_dir}/{key}.pt"))
            data = SyntheticDataset(SyntheticConfig(**data_cfg))
            for i in range(steps):
                state, m = trainer._step(state, batch_to_device(next(data), "cpu", pctx))
                for k in ("loss", "grad_norm", "clip_scale"):
                    res[f"{key}/{k}{i}"] = float(m[k])
            full = trainer.full_params(state)
            res[f"{key}/data_bytes"] = pctx.storage.ledger.class_bytes["data"]["fwd"]
            for j, x in enumerate(tree_leaves(full)):
                res[f"{key}/leaf{j}"] = x.numpy()
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def run_vlm(rank: int, world: int, init_file: str, data_dir: str, out: str, data: int, over,
            keys):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        res = {}
        for key, layout in keys:
            pctx = ParallelContext(device="cpu", impl="torch", data_degree=data,
                                   sp_degree=world // data, ring=dist.group.WORLD,
                                   layout=layout, mesh=data_mesh(data, world // data))
            trainer = Trainer(build_model(ARCHS["pixtral-12b"].reduced(**over), pctx),
                              TrainerConfig())
            state = trainer.state_from_params(torch.load(f"{data_dir}/params.pt"))
            batch = dict(np.load(f"{data_dir}/{key}.npz"))
            (_, m), grads = value_and_grad(trainer._loss, state["params"],
                                           batch_to_device(batch, "cpu", pctx))
            res[f"{key}/loss"] = float(m["loss"])
            full = unshard_tree(grads, trainer.params_layout, trainer.comm)
            for j, x in enumerate(tree_leaves(full)):
                res[f"{key}/leaf{j}"] = x.numpy()
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()

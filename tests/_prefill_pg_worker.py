"""One rank of the process-group check of the one-shot prefill at SP > 1
(``test_torch_prefill_sp.py``): gloo on the CPU, ``lm_prefill`` of the
replicated prompt (a VLM's patch embeddings first) over the group under
TokenRing, then decode steps fed the given tokens.  Writes the logits
(replicated) and this rank's shard of the dense slab after the prefill.
Imports torch, numpy and the port only."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import ParallelContext
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import build_model


def run(rank: int, P: int, init_file: str, data_dir: str, models, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=P)
    try:
        res = {}
        for model in models:
            case = np.load(f"{data_dir}/{model}.npz")
            cfg = ArchConfig(**torch.load(f"{data_dir}/{model}_cfg.pt"))
            pctx = ParallelContext(device="cpu", impl="torch", sp_degree=P, strategy="tokenring",
                                   ring=dist.group.WORLD)
            bundle = build_model(cfg, pctx)
            params = torch.load(f"{data_dir}/{model}_params.pt")
            state = bundle.init_serve_state(case["tokens"].shape[0], int(case["max_len"]), "cpu")
            prefix = torch.from_numpy(case["prefix"]) if "prefix" in case.files else None
            logits, state = bundle.prefill(params, torch.from_numpy(case["tokens"]),
                                           torch.from_numpy(case["pos"]), state, prefix)
            for key in ("k", "v", "pos", "len"):
                res[f"{model}/{key}"] = state[key].numpy().copy()
            rows = [logits.numpy()]
            for tok in case["feed"].T:
                logits, state = bundle.decode_step(params, torch.from_numpy(tok), state)
                rows.append(logits.numpy())
            res[f"{model}/logits"] = np.stack(rows, 1)
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()

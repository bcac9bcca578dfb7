"""One rank of the process-group ring check (``test_torch_ring_pg.py``):
gloo on the CPU, every variant on this rank's shard, forward and gradients
in both overlap modes, and the bytes of one forward pass.  Imports torch
and the port only, so that spawning it is quick."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import ParallelContext, sp_attention

VARIANTS = {  # name -> (strategy, travel dtype)
    "tokenring": ("tokenring", "float32"),
    "tokenring_travel_bf16": ("tokenring", "bfloat16"),
    "tokenring_faithful": ("tokenring_faithful", "float32"),
    "ring": ("ring", "float32"),
    "ring_bidir": ("ring_bidir", "float32"),
}


def run(rank: int, P: int, init_file: str, inputs: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=P)
    try:
        data = np.load(inputs)
        S_loc = data["q"].shape[1] // P
        rows = slice(rank * S_loc, (rank + 1) * S_loc)
        shard = {n: torch.from_numpy(np.ascontiguousarray(data[n][:, rows]))
                 for n in ("q", "k", "v", "w", "pos")}
        # a process group in place of a transport: the context wraps it
        ring = ParallelContext(device="cpu", sp_degree=P, ring=dist.group.WORLD).ring
        res = {}
        for name, (strategy, travel) in VARIANTS.items():
            for overlap in (True, False):
                pctx = ParallelContext(device="cpu", impl="torch", sp_degree=P,
                                       strategy=strategy, travel_dtype=travel,
                                       overlap=overlap, ring=ring)
                xs = [shard[n].clone().requires_grad_(True) for n in "qkv"]
                o = sp_attention(*xs, shard["pos"], shard["pos"], pctx=pctx, causal=True)
                grads = torch.autograd.grad((o.float() * shard["w"]).sum(), xs)
                for key, t in zip(("out", "dq", "dk", "dv"), (o, *grads)):
                    res[f"{name}/{overlap}/{key}"] = t.detach().float().numpy()
            ring.reset_counts()
            with torch.no_grad():
                sp_attention(shard["q"], shard["k"], shard["v"], shard["pos"], shard["pos"],
                             pctx=pctx, causal=True)
            res[f"{name}/bytes"] = np.array([ring.link_bytes["fwd"], ring.link_bytes["bwd"]])
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()


# The other strategies at P = 4 as 2 x 2 (test_torch_ring_pg.py's two-axis
# check): name -> (strategy, pods, layout); the hybrid's inner is `strategy`.
TWO_AXIS = {
    "ulysses": ("ulysses", 1, "zigzag"),
    "tokenring2d": ("tokenring2d", 2, "zigzag"),
    "hybrid_tokenring": ("tokenring", 2, "zigzag"),
    "hybrid_ulysses": ("ulysses", 2, "contig"),
}


def run_two_axis(rank: int, P: int, init_file: str, inputs: str, out: str):
    """Ulysses (all-to-all and all-gather over the group), TokenRing2D
    (through ``plan(topology=two_pods)``) and the hybrid (pods=2) on this
    rank's shard: output and gradients in both overlap modes, then the bytes
    of one forward pass, per link class."""
    from repro_torch.core.api import AttnShapes
    from repro_torch.core.topology import two_pods

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=P)
    try:
        data = np.load(inputs)
        ring = ParallelContext(device="cpu", sp_degree=P, ring=dist.group.WORLD).ring
        res = {}
        for name, (strategy, pods, layout) in TWO_AXIS.items():
            S_loc = data[f"{name}/q"].shape[1] // P
            rows = slice(rank * S_loc, (rank + 1) * S_loc)
            shard = {n: torch.from_numpy(np.ascontiguousarray(data[f"{name}/{n}"][:, rows]))
                     for n in ("q", "k", "v", "w", "qpos", "kpos")}
            B, _, Hq, D = shard["q"].shape
            shapes = AttnShapes(B=B, Sq=S_loc * P, Hq=Hq, Hkv=shard["k"].shape[2], D=D,
                                dtype_bytes=4)

            def attend(pctx, q, k, v):
                if strategy == "tokenring2d":
                    plan = pctx.plan(shapes, topology=two_pods(P // 2))
                    return plan(q, k, v, shard["qpos"], shard["kpos"])
                return sp_attention(q, k, v, shard["qpos"], shard["kpos"], pctx=pctx,
                                    causal=True)

            for overlap in (True, False):
                pctx = ParallelContext(device="cpu", impl="torch", sp_degree=P, pods=pods,
                                       strategy=strategy, layout=layout, overlap=overlap,
                                       ring=ring)
                xs = [shard[n].clone().requires_grad_(True) for n in "qkv"]
                o = attend(pctx, *xs)
                grads = torch.autograd.grad((o * shard["w"]).sum(), xs)
                for key, t in zip(("out", "dq", "dk", "dv"), (o, *grads)):
                    res[f"{name}/{overlap}/{key}"] = t.detach().numpy()
            ring.reset_counts()
            with torch.no_grad():
                attend(pctx, shard["q"], shard["k"], shard["v"])
            res[f"{name}/bytes"] = np.array([ring.link_bytes["fwd"], ring.link_bytes["bwd"]])
            for cls, way in ring.class_bytes.items():
                res[f"{name}/class/{cls}"] = np.array([way["fwd"], way["bwd"]])
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()

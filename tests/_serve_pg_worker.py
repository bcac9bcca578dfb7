"""One rank of the serve-storage decode on a gloo group
(``test_torch_serve_storage.py``, ``test_torch_serve_families.py``,
``test_torch_serve_pod.py``): the (data, model) or (pod, data, model) mesh
over the group, this rank's blocks of the parameters by
``param_pspec(mode="serve")`` (checked against ``cut_blocks`` of the full
leaf), then decode steps on the blocks: after the replicated prefill of its
data rank's rows, greedy (a case without ``feed``), or fed its rows of
``feed`` from a fresh state (whisper's encoded first from the rank's
sequence shard of its rows' frames).  Writes, per model, the logits and
tokens (greedy, or the logits' argmax) of its rows, whether its blocks were
the rule's, the bytes it holds, the ledger's bytes a step by class and,
with ``keep_state``, its state after the last step.
Imports torch, numpy and the port only."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import data_mesh, make_pctx
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sharding import (
    ServeBlocks,
    block_index,
    cut_blocks,
    layout_for,
    shard_tree,
    spec_leaves,
)


def _held(params, tree, layout, rank):
    """``(ok, bytes)``: whether every split leaf is the rule's block of the
    full leaf for ``rank`` (and every other leaf the full one), and the
    bytes the rank holds."""
    ok, held = True, 0
    for full, leaf, spec in zip(tree_leaves(params), tree_leaves(tree),
                                spec_leaves(layout.specs)):
        if isinstance(leaf, ServeBlocks):
            want = cut_blocks(full, spec, layout.mesh)[block_index(spec, layout.mesh, rank)]
            ok &= leaf.blocks.shape[0] == 1 and torch.equal(leaf.blocks[0], want)
            held += leaf.blocks.numel() * leaf.blocks.element_size()
        else:
            ok &= torch.equal(leaf, full)
            held += leaf.numel() * leaf.element_size()
    return ok, held


def run(rank: int, shape, init_file: str, data_dir: str, models, out: str, steps: int = 8,
        keep_state: bool = False):
    torch.set_num_threads(1)
    *pods, D, P = shape  # (data, model) or (pod, data, model)
    mesh = data_mesh(D, P, *pods)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=mesh.size)
    try:
        c = mesh.coords(rank)
        d = c["data"]
        res = {}
        for model in models:
            case = np.load(f"{data_dir}/{model}.npz")
            cfg = ArchConfig(**torch.load(f"{data_dir}/{model}_cfg.pt"))
            B = case["feed" if "feed" in case.files else "tokens"].shape[0]
            rows = slice(d * B // D, (d + 1) * B // D)
            pctx = make_pctx(mesh, device="cpu", impl="torch", global_batch=B,
                             layout=cfg.layout, ring=dist.group.WORLD)
            bundle = build_model(cfg, pctx)
            params = torch.load(f"{data_dir}/{model}_params.pt")
            layout = layout_for(params, mesh, rank=rank, mode="serve")
            tree = shard_tree(params, layout)
            res[f"{model}/blocks_ok"], res[f"{model}/held"] = _held(params, tree, layout, rank)
            state = bundle.init_serve_state(B // D, int(case["max_len"]), "cpu")
            fed = case["feed"][rows] if "feed" in case.files else None
            if fed is None:
                prefix = (torch.from_numpy(case["prefix"][rows]) if "prefix" in case.files
                          else None)
                logits, state = bundle.prefill(params, torch.from_numpy(case["tokens"][rows]),
                                               torch.from_numpy(case["pos"][rows]), state,
                                               prefix)
                tok = logits.argmax(-1).to(torch.int32)
            elif "frames" in case.files:  # its shard over the sequence axes, pod-major
                S = case["frames"].shape[1] // pctx.sp_degree
                m = c.get("pod", 0) * P + c["model"]
                bundle.encode(params, torch.from_numpy(case["frames"][rows, m * S:(m + 1) * S]),
                              state)
            del params
            got, feed, ledger = [], [], {}
            for t in range(steps if fed is None else fed.shape[1]):
                if fed is not None:
                    tok = torch.from_numpy(fed[:, t])
                feed.append(tok)
                pctx.storage.ledger.reset()
                logits, state = bundle.decode_step(tree, tok, state)
                ledger = pctx.storage.ledger.class_bytes
                got.append(logits.numpy())
                tok = logits.argmax(-1).to(torch.int32)
            res[f"{model}/logits"] = np.stack(got, 1)
            res[f"{model}/tokens"] = (torch.stack(feed, 1).numpy() if fed is None
                                      else res[f"{model}/logits"].argmax(-1))
            for cls in ("tp", "link", "data", "intra"):
                n = ledger.get(cls, {"fwd": 0.0, "bwd": 0.0})
                res[f"{model}/{cls}"] = np.asarray([n["fwd"], n["bwd"]])
            if keep_state:
                res.update({f"{model}/state/{k}": v.numpy() for k, v in state.items()})
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()

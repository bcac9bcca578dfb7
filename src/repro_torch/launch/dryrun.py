"""Multi-pod dry run (port of ``repro.launch.dryrun``): every (arch x shape x
mesh) cell's step traced at full depth and width on rank 0 of the production
mesh, without a card.

The reference lowers and compiles each cell's step for 256 or 512 simulated
devices and reads XLA's memory analysis and the post-SPMD HLO.  The port
runs rank 0's step itself, on fake tensors (``torch._subclasses.
fake_tensor``: shapes, dtypes and a ``cuda`` device, no storage), over a
``"fake"`` ``torch.distributed`` process group of ``mesh.size`` ranks whose
collectives move nothing: the step goes through the same transports
(``ProcessGroupRing``, ``ProcessGroupMeshComm``), sharding and kernel
wrappers as a real cluster with one rank a card.  ``launch.step_analysis``
watches it: the per-rank memory high-water and its split, the products' and
the kernels' flops and bytes, the collectives, and the transports' own
ledger of link bytes a direction and class; from those, the roofline at an
H100 SXM5's datasheet figures.  Results land as JSON under
``experiments/artifacts_torch/``.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
  ... --strategy tokenring|tokenring_faithful|ring|ring_bidir|auto
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, ASSIGNED
from repro_torch.launch import step_analysis as sa
from repro_torch.launch.mesh import make_pctx, make_production_mesh
from repro_torch.launch.train_step import make_train_step, step_loss
from repro_torch.models.config import SHAPES
from repro_torch.models.registry import build_model, input_specs, runnable
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding import (
    ServeBlocks,
    batch_shardings,
    block_index,
    cut_blocks,
    gather_step_params,
    layout_for,
    map_with_path,
    shard_tree,
    tree_bytes,
)

__all__ = ["run_cell", "trace_step", "meta_params", "param_counts", "fake_world", "fake_device",
           "main",
           "ARTIFACT_DIR"]

ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "experiments", "artifacts_torch",
)

_EXPERT_KEYS = ("wg", "wu", "wd")
# the families whose prefill cell runs lm_prefill into its cache; the others
# run their loss's forward pass without gradients (the reference's proxy)
ONE_SHOT_PREFILL = ("dense", "moe", "vlm")


def meta_params(cfg, training: bool = False):
    """``cfg``'s full parameter tree as meta tensors (``training``: the
    training layout's dtypes)."""
    from repro_torch.models import encdec, mamba, rglru, transformer

    init = {"encdec": encdec.init_encdec, "ssm": mamba.init_mamba_lm, "hybrid": rglru.init_rg}
    return init.get(cfg.family, transformer.init_lm)(cfg, None, device="meta",
                                                     training=training)


def param_counts(params, cfg) -> tuple[int, float]:
    """``(total, active)`` parameters: an expert stack (``wg``/``wu``/``wd``)
    counts ``n_experts_per_token / n_experts`` of itself as active."""
    total = expert = 0

    def leaf(path, x):
        nonlocal total, expert
        n = math.prod(x.shape)
        total += n
        keys = [k for k in path if isinstance(k, str)]
        if keys and keys[-1] in _EXPERT_KEYS:
            expert += n

    map_with_path(leaf, params)
    active = total
    if cfg.n_experts:
        active = total - expert + expert * cfg.n_experts_per_token / cfg.n_experts
    return total, active


def fake_world(world: int):
    """This process's ``"fake"`` process group of ``world`` ranks, rank 0
    (one per process: a group of another size is replaced).  Returns the
    seconds it took."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    t0 = time.perf_counter()
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs this process's default group for its fake "
                               f"world; a {dist.get_backend()!r} group holds it")
        if dist.get_world_size() == world:
            return 0.0
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return time.perf_counter() - t0


def fake_device() -> str:
    """The device of the dry run's fake tensors: ``"cuda"`` where a card is
    visible; ``"cpu"`` where none is, since autograd cannot run on fake CUDA
    tensors without the card's device guard (the kernel wrappers take fakes
    of either device to their shape path: ``kernels.ops``)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _empty_like_tree(tree, device):
    """Every leaf of a tree of meta tensors (and :class:`ServeBlocks` of
    them) as an empty tensor of its shape and dtype on ``device``."""
    def leaf(x):
        if isinstance(x, ServeBlocks):
            return dataclasses.replace(x, blocks=leaf(x.blocks))
        return torch.empty(x.shape, dtype=x.dtype, device=device)

    if isinstance(tree, dict):
        return {k: _empty_like_tree(tree[k], device) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_empty_like_tree(x, device) for x in tree)
    return leaf(tree)


def _global_positions(cfg, shape, pctx):
    """The batch's positions ``(B, S)`` (int32), as ``data.synthetic``
    arranges them for the context's layout; a VLM's cover its image
    prefix."""
    from repro_torch.data.synthetic import apply_layout
    import numpy as np

    B, S = shape.global_batch, shape.seq_len
    _, _, pos = apply_layout(np.zeros((1, S), np.int32), np.zeros((1, S), np.int32), S,
                             pctx.sp_degree, cfg.layout)
    return torch.from_numpy(np.broadcast_to(pos, (B, S)).copy())


def _batch_blocks(cfg, shape, pctx, kind):
    """Rank 0's block of the cell's batch: ``{name: (shape, dtype, value)}``,
    ``value`` rank 0's positions (``None`` for the other leaves); a VLM's
    text is whole over the sequence (``sharding.batch_block``), and
    ``lm_prefill`` takes its tokens and positions whole and slices its own.
    A family without ``lm_prefill`` prefills by its loss's forward pass, on
    the training batch's blocks."""
    _, specs = input_specs(cfg, shape)
    mesh = pctx.mesh
    out = {}
    one_shot = kind == "prefill" and cfg.family in ONE_SHOT_PREFILL
    for name, (shp, dt) in specs.items():
        spec = None
        if mesh is not None:
            spec = batch_shardings({name: torch.empty(shp, device="meta")}, mesh, pctx)[name]
            spec = tuple(spec)[:len(shp)] + (None,) * (len(shp) - len(spec))
            if one_shot or (cfg.family == "vlm" and name in ("tokens", "labels")):
                spec = (spec[0],) + (None,) * (len(shp) - 1)  # sharding.batch_block
        value = None
        if name == "positions":
            value = _global_positions(cfg, shape, pctx)
            if mesh is not None:
                value = cut_blocks(value, spec, mesh)[block_index(spec, mesh, 0)]
        block = shp if mesh is None else tuple(
            cut_blocks(torch.empty(shp, device="meta"), spec, mesh).shape[1:])
        out[name] = (block, dt, value)
    return out


def _seq_blocks(cfg, shape, pctx):
    """Every sequence rank's block of a batch row's positions ``(P, S/P)``,
    rank 0's first (``StepAnalysis``'s ``seq_blocks``)."""
    row = _global_positions(cfg, shape, pctx)[0]
    return row.reshape(pctx.sp_degree, -1)


def _seed_state_shadows(state, cfg, shape, pctx, analysis):
    """Rank 0's decode state positions as a full cache leaves them: every
    slot up to ``seq_len - 1`` tokens written (the new token takes the
    last), a ring buffer of ``window`` slots holding the latest positions,
    the encoder's positions in order; rank 0's slots are the first of the
    cache's sequence layout (``sharding.serve_state_shardings``)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    from repro_torch.kernels.ref import PAD_POS

    length = shape.seq_len - 1
    with unset_fake_temporarily():
        if "len" in state:
            analysis.shadow(state["len"], torch.full(state["len"].shape, length,
                                                     dtype=torch.int32))
        if "pos" in state:
            rows, n = state["pos"].shape
            s = torch.arange(n, dtype=torch.int32)
            val = None
            if n * pctx.sp_degree == shape.seq_len:
                val = torch.where(s < length, s, PAD_POS)
            elif cfg.window and n * pctx.sp_degree == cfg.window:
                val = s + cfg.window * ((length - 1 - s) // cfg.window)
            if val is not None:
                analysis.shadow(state["pos"], val.expand(rows, n))
        if "enc_pos" in state:
            rows, n = state["enc_pos"].shape
            analysis.shadow(state["enc_pos"],
                            torch.arange(n, dtype=torch.int32).expand(rows, n))


@contextlib.contextmanager
def _fake_mode():
    """A fake-tensor mode.  The sinusoid tables ``models.encdec`` caches
    are dropped before and after it: a fake tensor belongs to the mode that
    made it, and a real one cannot enter it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.encdec import _sinusoid_table

    _sinusoid_table.cache_clear()
    try:
        with FakeTensorMode():
            yield
    finally:
        _sinusoid_table.cache_clear()


def trace_step(cfg, shape, pctx):
    """Run ``pctx``'s rank's step of the (cfg, shape) cell on fake tensors
    under :class:`step_analysis.StepAnalysis`, by the shape's kind:
    ``"train"`` (gradients and an AdamW step, on FSDP blocks over a mesh),
    ``"prefill"`` or ``"decode"`` (one token, on serve blocks over a mesh).
    Returns the analysis, the step's state bytes going in and out, and
    the ledger's class bytes."""
    kind = shape.kind
    mesh = pctx.mesh
    rank = pctx.storage.rank if pctx.storage is not None and not pctx.storage.folded else 0
    device = pctx.device
    bundle = build_model(cfg, pctx)
    meta = meta_params(cfg, training=kind == "train")
    ledger = pctx.storage.ledger if pctx.storage is not None else (
        pctx.ring.ledger if pctx.ring is not None else None)
    analysis = sa.StepAnalysis(
        ledger=ledger, seq_blocks=_seq_blocks(cfg, shape, pctx) if kind != "decode" else None)
    if mesh is None:
        layout, blocks = None, meta
    else:
        layout = layout_for(meta, mesh, rank=rank, mode="serve" if kind == "decode" else "train")
        blocks = shard_tree(meta, layout)
    batch_blocks = _batch_blocks(cfg, shape, pctx, kind) if kind != "decode" else {}
    with _fake_mode():
        params = _empty_like_tree(blocks, device)
        batch = {}
        for name, (shp, dt, value) in batch_blocks.items():
            batch[name] = torch.empty(shp, dtype=dt, device=device)
            if value is not None:
                analysis.shadow(batch[name], value)
        analysis.track(params, "params")
        args_bytes = tree_bytes(params)
        out_bytes = 0
        if kind == "train":
            opt = adamw_init(params)
            analysis.track(opt, "opt")
            analysis.track(batch, "batch")
            args_bytes += tree_bytes(opt) + tree_bytes(batch)
            step = make_train_step(bundle, layout=layout)
            if ledger is not None:
                ledger.reset()
            with analysis:
                params, opt, metrics = step(params, opt, batch)
                out_bytes = tree_bytes(params) + tree_bytes(opt) + tree_bytes(metrics)
        elif kind == "prefill":
            B = batch["tokens"].shape[0]
            analysis.track(batch, "batch")
            args_bytes += tree_bytes(batch)
            if cfg.family in ONE_SHOT_PREFILL:
                cache = bundle.init_serve_state(B, shape.seq_len, device)
                analysis.track(cache, "state")
                args_bytes += tree_bytes(cache)
                full = (gather_step_params if layout is not None else None)
                if ledger is not None:
                    ledger.reset()
                with analysis:
                    p = full(params, layout, pctx.storage) if full else params
                    logits, cache = bundle.prefill(p, batch["tokens"], batch["positions"],
                                                   cache, batch.get("patch_embeds"))
                    del p
                    out_bytes = tree_bytes(logits) + tree_bytes(cache)
            else:
                loss_fn = step_loss(bundle, layout)
                if ledger is not None:
                    ledger.reset()
                with analysis, torch.no_grad():
                    loss, metrics = loss_fn(params, batch)
                    out_bytes = tree_bytes(loss) + tree_bytes(metrics)
        else:
            B = input_specs(cfg, shape)[1]["token_ids"][0][0] // pctx.data_degree
            state = bundle.init_serve_state(B, shape.seq_len, device)
            _seed_state_shadows(state, cfg, shape, pctx, analysis)
            tok = torch.empty((B,), dtype=torch.int32, device=device)
            analysis.track(state, "state")
            analysis.track(tok, "batch")
            args_bytes += tree_bytes(state) + tree_bytes(tok)
            if ledger is not None:
                ledger.reset()
            with analysis:
                logits, state = bundle.decode_step(params, tok, state)
                out_bytes = tree_bytes(logits) + tree_bytes(state)
    class_bytes = ({k: dict(v) for k, v in ledger.class_bytes.items()}
                   if ledger is not None else {})
    gathered_high = ledger.gathered_high if ledger is not None else 0
    return {"analysis": analysis, "meta": meta, "argument_bytes": args_bytes,
            "output_bytes": out_bytes, "class_bytes": class_bytes,
            "gathered_high": gathered_high, "kind": kind}


def memory_record(traced) -> dict:
    """The record's ``memory`` block from :func:`trace_step`'s result."""
    mem = traced["analysis"].memory()
    args, outs = traced["argument_bytes"], traced["output_bytes"]
    return {
        "argument_bytes_per_device": args,
        "output_bytes_per_device": outs,
        "temp_bytes_per_device": max(mem["peak_bytes"] - args, 0),
        "peak_bytes_per_device": mem["peak_bytes"],
        "split_at_peak": {k: mem[k] for k in ("params", "opt", "batch", "state", "gradients",
                                              "gathered", "rest")},
        "gathered_high_bytes": traced["gathered_high"],
    }


def _plan_info(cfg, shape, pctx, kind, mesh):
    """The planner's view of the cell's attention (the reference's record):
    the resolved strategy, its predicted link bytes and modeled times,
    adaptive-prefill picks, the two-pod topology decision; the decode
    schedule for decode cells."""
    from repro_torch.core.api import AttnShapes

    dtype_bytes = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    bws = sa.link_bandwidths(mesh)
    if kind != "decode" and pctx.active and cfg.family != "ssm":
        shapes = AttnShapes(B=shape.global_batch, Sq=shape.seq_len, Hq=cfg.n_heads,
                            Hkv=cfg.n_kv_heads, D=cfg.head_dim, dtype_bytes=dtype_bytes)
        try:
            plan = pctx.plan(shapes, causal=cfg.causal, window=cfg.window)
            info = {
                "strategy": plan.strategy,
                "inner": plan.inner,
                "predicted_link_bytes_fwd": plan.cost.fwd_bytes,
                "predicted_link_bytes_bwd": plan.cost.bwd_bytes,
                "modeled_times": plan.modeled_times(link_bw=bws.get("link", sa.NIC_BW),
                                                    peak_flops=sa.PEAK_FLOPS,
                                                    bidir_links=pctx.bidir_links),
                "kernel": {"impl": pctx.impl, "block_q": pctx.block_q,
                           "block_k": pctx.block_k,
                           "block_q_bwd": pctx.block_q_bwd or pctx.block_q,
                           "block_k_bwd": pctx.block_k_bwd or pctx.block_k},
            }
            if kind == "prefill":
                info["adaptive_prefill"] = {
                    f"hit_rate_{r}": pctx.choose_prefill_strategy(shapes, prefix_hit_rate=r)
                    for r in (0.0, 0.5, 0.95)}
            sp_axes = ("pod", "model") if pctx.pods > 1 else ("model",)
            if len(sp_axes) == 2 and mesh.shape[sp_axes[0]] == 2:
                from repro_torch.core.topology import two_pods

                tplan = pctx.plan(shapes, causal=cfg.causal, window=cfg.window,
                                  topology=two_pods(pctx.sp_degree // 2))
                info["topology"] = tplan.topology_decision
        except ValueError as e:
            info = {"error": str(e)}
        return info
    if kind == "decode" and pctx.active and cfg.family in ("dense", "moe", "vlm"):
        try:
            plan = pctx.plan_decode(window=cfg.window, shapes=AttnShapes(
                B=shape.global_batch, Sq=1, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads,
                D=cfg.head_dim, Sk=shape.seq_len, dtype_bytes=dtype_bytes))
            return {"strategy": plan.strategy, "inner": plan.inner,
                    "predicted_link_bytes_fwd": plan.cost.fwd_bytes,
                    "predicted_link_bytes_bwd": plan.cost.bwd_bytes, "kernel": plan.kernel}
        except ValueError as e:
            return {"error": str(e)}
    return None


def run_cell(arch, shape_name, *, multi_pod, strategy, out_dir, force=False,
             travel_dtype="float32"):
    """Trace one cell on rank 0 of the production mesh and write its record
    (``<out_dir>/<arch>__<shape>__<pod|multipod>__<strategy>.json``)."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    ok, why = runnable(cfg, shape)
    mesh_tag = "multipod" if multi_pod else "pod"
    tag = f"{arch}__{shape_name}__{mesh_tag}__{strategy}"
    if travel_dtype != "float32":
        tag += "__tw" + travel_dtype
    out_path = os.path.join(out_dir, tag + ".json")
    if not force and os.path.exists(out_path):
        print(f"[skip-cached] {tag}")
        with open(out_path) as f:
            return json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "strategy": strategy,
               "status": "skipped", "reason": why}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[skip] {tag}: {why}")
        return rec

    import torch.distributed as dist

    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    world = mesh.size
    t_world = fake_world(world)
    if shape.kind != "train":
        cfg = cfg.with_(param_dtype="bfloat16", remat="none")
    t1 = time.perf_counter()
    pctx = make_pctx(mesh, strategy=strategy, layout=cfg.layout, global_batch=shape.global_batch,
                     device=fake_device(), ring=dist.group.WORLD)
    t_groups = time.perf_counter() - t1
    if travel_dtype != "float32":
        pctx = dataclasses.replace(pctx, travel_dtype=travel_dtype)
    kind = shape.kind
    plan_info = _plan_info(cfg, shape, pctx, kind, mesh)
    t2 = time.perf_counter()
    traced = trace_step(cfg, shape, pctx)
    t_trace = time.perf_counter() - t2
    analysis = traced["analysis"]
    total_params, active_params = param_counts(traced["meta"], cfg)
    if kind == "train":
        model_flops = 6.0 * active_params * shape.global_batch * shape.seq_len
    elif kind == "prefill":
        model_flops = 2.0 * active_params * shape.global_batch * shape.seq_len
    else:
        model_flops = 2.0 * active_params * shape.global_batch
    stats = analysis.stats
    per_dev = stats.as_dict()
    per_dev["link_bytes_fwd"] = sum(b["fwd"] for b in traced["class_bytes"].values())
    per_dev["link_bytes_bwd"] = sum(b["bwd"] for b in traced["class_bytes"].values())
    per_dev["link_bytes_by_class"] = traced["class_bytes"]
    bws = sa.link_bandwidths(mesh)
    roof = sa.roofline(stats, traced["class_bytes"], bws)
    bound = roof["bound_s"]
    mf_dev = model_flops / world
    ideal_decode_s = None
    if kind == "decode":
        ideal = tree_bytes(meta_params(cfg)) + _state_bytes_global(cfg, shape)
        ideal_decode_s = ideal / world / sa.HBM_BW
        frac = ideal_decode_s / bound if bound else 0.0
    else:
        frac = (mf_dev / sa.PEAK_FLOPS) / bound if bound else 0.0
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_tag,
        "mesh_shape": dict(mesh.shape),
        "strategy": strategy,
        "plan": plan_info,
        "layout": cfg.layout,
        "kind": kind,
        "status": "ok",
        "world": world,
        "params_total": total_params,
        "params_active": active_params,
        "model_flops_total": model_flops,
        "model_flops_per_device": mf_dev,
        "memory": memory_record(traced),
        "step_stats_per_device": per_dev,
        "attention_model": {
            "computed_flops_per_device": stats.attention_flops,
            "masked_full_flops_per_device": stats.attention_flops_full,
            "calls_unresolved": stats.attention_calls_unresolved,
        },
        "roofline": {
            **roof,
            "link_bandwidths": bws,
            "useful_flops_ratio": mf_dev / max(stats.dot_flops + stats.attention_flops, 1.0),
            "roofline_fraction": frac,
            "decode_ideal_memory_s": ideal_decode_s,
            "constants": {"peak_flops": sa.PEAK_FLOPS, "hbm_bw": sa.HBM_BW,
                          "nvlink_bw": sa.NVLINK_BW, "nic_bw": sa.NIC_BW,
                          "source": "datasheet, H100 SXM5 80GB HBM3 at 700 W"},
        },
        "timing": {"world_s": t_world, "groups_s": t_groups, "trace_s": t_trace,
                   "cell_s": time.perf_counter() - t0},
    }
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    m = rec["memory"]
    print(f"[ok] {tag}: trace {t_trace:.1f}s peak/dev {m['peak_bytes_per_device'] / 2**30:.2f} "
          f"GiB (state {m['argument_bytes_per_device'] / 2**30:.2f} GiB) dominant "
          f"{roof['dominant']} bound {bound * 1e3:.2f} ms roofline {frac * 100:.1f}%")
    return rec


def _state_bytes_global(cfg, shape) -> int:
    """Bytes of the whole decode state of the cell (every rank's)."""
    from repro_torch.core.api import ParallelContext

    bundle = build_model(cfg, ParallelContext(device="meta"))
    return tree_bytes(bundle.init_serve_state(shape.global_batch, shape.seq_len, "meta"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"], default="off")
    ap.add_argument("--strategy", default="tokenring")
    ap.add_argument("--travel-dtype", default="float32")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    pods = {"off": [False], "on": [True], "both": [False, True]}[args.multi_pod]
    cells = [(a, s, mp) for mp in pods for a in archs for s in shapes]
    failures = []
    for arch, shape, mp in cells:
        try:
            run_cell(arch, shape, multi_pod=mp, strategy=args.strategy, out_dir=args.out,
                     force=args.force, travel_dtype=args.travel_dtype)
        except Exception as e:  # noqa: BLE001 - a cell's failure is reported, the sweep goes on
            failures.append((arch, shape, mp, repr(e)))
            print(f"[FAIL] {arch} {shape} mp={mp}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nDRY-RUN: all requested cells traced.")


if __name__ == "__main__":
    main()

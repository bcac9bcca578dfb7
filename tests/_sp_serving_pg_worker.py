"""One rank of the process-group serving check (``test_torch_sp_serving.py``):
gloo on the CPU, ``sp_decode``, ``sp_decode_paged`` and ``sp_prefill`` on
this rank's cache shard with their all-reduce bytes and, with ``engine``,
the reduced paged and dense engines (greedy and sampled) holding only this
rank's shard.  Imports torch and the port only, so that spawning it is
quick."""

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import ParallelContext, sp_decode, sp_decode_paged, sp_prefill

ENGINE_PROMPTS = ((9, 12), (5, 6), (13, 8))  # (prompt length, new tokens)
ENGINE_REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=32, d_ff=128,
                      vocab_size=97)
ENGINE_KW = dict(max_batch=2, max_len=64, prefill_chunk=4, token_budget=6)
ENGINE_RUNS = {  # name -> (page size or None, temperature)
    "paged_greedy": (4, 0.0),
    "paged_sampled": (4, 1.0),
    "dense_greedy": (None, 0.0),
}


def engine_outputs(bundle, params, page_size, temperature):
    """Tokens of the three requests through a fresh engine, and its state."""
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(bundle, params, device="cpu", page_size=page_size,
                        temperature=temperature, seed=7, **ENGINE_KW)
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(1, 90, n), max_new_tokens=m) for n, m in ENGINE_PROMPTS]
    eng.run()
    return [r.output for r in reqs], eng


def run(rank: int, P: int, init_file: str, inputs: str, out: str, engine: bool):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=P)
    try:
        d = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
        pctx = ParallelContext(device="cpu", impl="torch", sp_degree=P, ring=dist.group.WORLD)
        ring = pctx.ring
        s_loc = d["k"].shape[1] // P
        rows = slice(rank * s_loc, (rank + 1) * s_loc)
        n_local = d["p_k_pool"].shape[0] // P
        pages = slice(rank * n_local, (rank + 1) * n_local)
        res = {}
        ring.reset_counts()
        res["decode"] = sp_decode(d["q"], d["k"][:, rows], d["v"][:, rows], d["k_pos"][:, rows],
                                  d["q_pos"], pctx=pctx, window=int(d["window"])).numpy()
        res["decode/bytes"] = np.array([ring.link_bytes["fwd"], ring.link_bytes["bwd"]])
        ring.reset_counts()
        res["paged"] = sp_decode_paged(
            d["p_q"], d["p_k_pool"][pages], d["p_v_pool"][pages], d["p_pos_pool"][pages],
            d["p_block_tables"], d["p_q_pos"], d["p_lengths"], pctx=pctx).numpy()
        res["paged/bytes"] = np.array([ring.link_bytes["fwd"], ring.link_bytes["bwd"]])
        ring.reset_counts()
        res["prefill"] = sp_prefill(
            d["cq"], d["ck"], d["cv"], d["c_pos"], d["k"][:, rows], d["v"][:, rows],
            d["k_pos"][:, rows], d["c_pos"], pctx=pctx).numpy()
        res["prefill/bytes"] = np.array([ring.link_bytes["fwd"], ring.link_bytes["bwd"]])
        if engine:
            from repro_torch.configs import ARCHS
            from repro_torch.models.registry import build_model

            cfg = ARCHS["qwen3-1.7b"].reduced(**ENGINE_REDUCED)
            bundle = build_model(cfg, pctx)
            params = bundle.init(0)
            for name, (page_size, temperature) in ENGINE_RUNS.items():
                outs, eng = engine_outputs(bundle, params, page_size, temperature)
                res[f"engine/{name}"] = np.array([t for o in outs for t in o])
                res[f"engine/{name}/held"] = np.array(eng.state["k"].shape[1:3])
        np.savez(out, **res)
    finally:
        dist.destroy_process_group()

"""The decode step under serve storage (``repro_torch.sharding``'s
``mode="serve"`` layout, the reference's Megatron layout for decode):
``lm_decode_step`` on ``ServeBlocks`` leaves, each rank's blocks resident,
with the tensor-parallel collectives of ``models/layers.py``.

* reduced qwen3-1.7b, qwen2-72b (qkv bias), olmo-1b (non-parametric
  LayerNorm, tied embeddings), qwen3-moe-30b-a3b and llama4-scout-17b-a16e
  (capacity factor E / K: nothing drops) and pixtral-12b (its patch
  embeddings prefilled first), parameters from the JAX ``init`` carried
  across with ``from_jax_params``: the port's replicated ``lm_prefill`` at
  SP = the model size, then 8 greedy decode steps on the blocks over the
  virtual (1, 2), (1, 4) and (2, 2) meshes, each step's logits against the
  JAX ``lm_decode_step`` at ``mesh=None`` at ``MODEL_TOL``, the greedy
  tokens equal;
* each rank's blocks equal ``cut_blocks`` of the full leaf by
  ``param_pspec(mode="serve")``, ``state_bytes`` equals the bytes a rank
  holds, the ledger's bytes of every step equal ``serve_comm_bytes`` in
  every class, exactly;
* the cache's SP layout holds, rank by rank, the blocks that
  ``serve_state_shardings`` gives it;
* the layers on every split a spec can give (embedding by ``d`` and by
  vocabulary, column and row products with split and whole biases, the
  swiglu and gelu pairs and the unpaired fallback);
* a serve layout survives ``with_mesh``; serve blocks outside the decode
  step, or without a context over their mesh, are refused;
* the same decode on gloo groups of (1, 2) and (2, 2) spawned ranks
  (``_serve_pg_worker.py``), each rank holding its blocks only.
"""

import dataclasses
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_data_parallel import MODEL_TOL

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.models import build_model as jbuild
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.collectives import fold_ranks
from repro_torch.launch.mesh import Mesh, data_mesh, make_pctx
from repro_torch.models import layers as L
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.models.transformer import serve_comm_bytes
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sharding import (
    ServeBlocks,
    block_index,
    cut_blocks,
    layout_for,
    param_pspec,
    serve_state_shardings,
    shard_tree,
    spec_leaves,
    state_bytes,
)

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
             vocab_size=97, moe_d_ff=32)
# (arch, overrides): the capacity factor of the MoE configs is E / K
MODELS = {"qwen3": ("qwen3-1.7b", {}), "qwen2-72b": ("qwen2-72b", {}),
          "olmo": ("olmo-1b", {}), "qwen3-moe": ("qwen3-moe-30b-a3b", {}),
          "llama4": ("llama4-scout-17b-a16e", {}), "pixtral": ("pixtral-12b", {})}
MESHES = [(1, 2), (1, 4), (2, 2)]
B, S_TEXT, MAX_LEN, STEPS = 4, 16, 64, 8
SPAWN_TIMEOUT_S = 90


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(model):
    name, over = MODELS[model]
    jcfg = JARCHS[name].reduced(**dict(SMALL, **over))
    if jcfg.n_experts:
        over = dict(over, capacity_factor=jcfg.n_experts / jcfg.n_experts_per_token)
    return JARCHS[name].reduced(**dict(SMALL, **over)), TARCHS[name].reduced(**dict(SMALL, **over))


_CASES = {}


def _case(model):
    """``(tcfg, params, inputs, want)``: the port's serving parameters from
    the JAX init, the prompt (patch embeddings first for pixtral), and the
    JAX prefill plus greedy decode at ``mesh=None`` (``want["logits"]``:
    the decode steps' logits, ``want["tokens"]``: the tokens fed)."""
    if model not in _CASES:
        jcfg, tcfg = _configs(model)
        jb = jbuild(jcfg, JPctx(mesh=None, impl="xla"))
        jparams = jb.init(jax.random.PRNGKey(11))
        rng = np.random.default_rng(len(model))
        tokens = rng.integers(0, tcfg.vocab_size, (B, S_TEXT)).astype(np.int32)
        prefix = (rng.standard_normal((B, tcfg.frontend_tokens, tcfg.d_model))
                  .astype(np.float32) if tcfg.frontend_tokens else None)
        S = S_TEXT + (0 if prefix is None else prefix.shape[1])
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
        logits, state = jb.prefill(jparams, jnp.asarray(tokens), jnp.asarray(pos),
                                   jb.init_serve_state(B, MAX_LEN),
                                   None if prefix is None else jnp.asarray(prefix))
        step = jax.jit(jb.decode_step)
        rows, feed = [], []
        tok = np.asarray(logits).argmax(-1).astype(np.int32)
        for _ in range(STEPS):
            feed.append(tok)
            logits, state = step(jparams, jnp.asarray(tok), state)
            rows.append(np.asarray(logits))
            tok = rows[-1].argmax(-1).astype(np.int32)
        inputs = dict(tokens=tokens, pos=pos, max_len=np.asarray(MAX_LEN))
        if prefix is not None:
            inputs["prefix"] = prefix
        params = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        _CASES[model] = (tcfg, params, inputs,
                         dict(logits=np.stack(rows, 1), tokens=np.stack(feed, 1)))
    return _CASES[model]


def _check_blocks(params, blocks, layout):
    """Every rank's blocks are ``cut_blocks`` of the full leaf by the serve
    spec; ``state_bytes`` is the bytes a rank holds."""
    mesh = layout.mesh
    held = [0] * mesh.size
    for full, leaf, spec in zip(tree_leaves(params), tree_leaves(blocks),
                                spec_leaves(layout.specs)):
        if isinstance(leaf, ServeBlocks):
            assert leaf.spec == spec and leaf.shape == tuple(full.shape)
            want = cut_blocks(full, spec, mesh)
            assert torch.equal(leaf.blocks, want)
            for r in range(mesh.size):
                held[r] += want[block_index(spec, mesh, r)].numel() * full.element_size()
        else:
            assert torch.equal(leaf, full)
            assert spec is None or all(e is None for e in spec) or mesh.shape["model"] == 1
            for r in range(mesh.size):
                held[r] += full.numel() * full.element_size()
    assert held == [state_bytes(layout, r) for r in range(mesh.size)]


def _serve_run(tcfg, params, inputs, mesh):
    """Prefill (replicated) then STEPS greedy decode steps on serve blocks
    over the virtual ``mesh``: the logits ``(B, STEPS, V)``, the tokens
    fed, each step's ledger, the layout, the blocks and the state after."""
    pctx = make_pctx(mesh, device="cpu", impl="torch", global_batch=B)
    tb = tbuild(tcfg, pctx)
    state = tb.init_serve_state(B, MAX_LEN, "cpu")
    prefix = inputs.get("prefix")
    logits, state = tb.prefill(params, torch.from_numpy(inputs["tokens"]),
                               torch.from_numpy(inputs["pos"]), state,
                               None if prefix is None else torch.from_numpy(prefix))
    layout = layout_for(params, mesh, mode="serve")
    tree = shard_tree(params, layout)
    rows, feed, ledgers = [], [], []
    tok = logits.argmax(-1).to(torch.int32)
    for _ in range(STEPS):
        feed.append(tok)
        pctx.storage.ledger.reset()
        logits, state = tb.decode_step(tree, tok, state)
        ledgers.append({c: dict(v) for c, v in pctx.storage.ledger.class_bytes.items()})
        rows.append(logits.numpy())
        tok = logits.argmax(-1).to(torch.int32)
    return dict(logits=np.stack(rows, 1), tokens=torch.stack(feed, 1).numpy(),
                ledgers=ledgers, layout=layout, tree=tree, state=state, pctx=pctx)


def _check_bytes(ledgers, layout, cfg, rows):
    want = serve_comm_bytes(layout, cfg, rows)
    assert want["tp"]["fwd"] > 0 and want["data"]["fwd"] == 0
    for got in ledgers:
        assert set(got) <= set(want)
        for cls in want:
            assert got.get(cls, {"fwd": 0.0, "bwd": 0.0}) == want[cls], cls


@pytest.mark.parametrize("mesh_shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_serve_decode_matches_jax(model, mesh_shape):
    tcfg, params, inputs, want = _case(model)
    mesh = data_mesh(*mesh_shape)
    got = _serve_run(tcfg, params, inputs, mesh)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], **MODEL_TOL)
    _check_blocks(params, got["tree"], got["layout"])
    _check_bytes(got["ledgers"], got["layout"], tcfg, B // got["pctx"].data_degree)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_cache_layout_agrees_with_serve_state_shardings(mesh_shape):
    """Rank (d, m)'s rows of the slab in its SP layout (rank-major on the
    virtual ring: model rank m's rows, data rank d's part of them) are the
    block of the global cache that ``serve_state_shardings`` gives it."""
    tcfg, params, inputs, _ = _case("qwen3")
    mesh = data_mesh(*mesh_shape)
    got = _serve_run(tcfg, params, inputs, mesh)
    pctx, state = got["pctx"], got["state"]
    P, D = mesh.shape["model"], mesh.shape["data"]
    specs = serve_state_shardings(state, mesh, pctx, tcfg)
    assert specs["k"] == (None, "data", "model", None, None) and specs["pos"] == ("data", "model")
    glob = {"k": state["k"].reshape(tcfg.n_layers, P, B, -1, *state["k"].shape[3:])
            .transpose(1, 2).reshape(tcfg.n_layers, B, -1, *state["k"].shape[3:]),
            "pos": state["pos"].reshape(P, B, -1).transpose(0, 1).reshape(B, -1)}
    assert torch.equal(fold_ranks(glob["pos"], P), state["pos"])
    for r in range(mesh.size):
        c = mesh.coords(r)
        rows = slice(c["model"] * B + c["data"] * B // D, c["model"] * B + (c["data"] + 1) * B // D)
        for key in ("k", "pos"):
            block = cut_blocks(glob[key], specs[key], mesh)[block_index(specs[key], mesh, r)]
            mine = state[key][:, rows] if key == "k" else state[key][rows]
            assert torch.equal(block, mine), (key, r)
    assert specs["len"] == ("data",)


def _blocks(full, spec, mesh):
    return ServeBlocks(cut_blocks(full, spec, mesh).contiguous(), spec, mesh,
                       make_pctx(mesh, device="cpu", impl="torch").storage)


LAYER_CASES = ["embed_d", "embed_vocab", "dense_col_bias", "dense_row_bias", "swiglu_pair",
               "gelu_pair", "swiglu_unpaired", "layernorm"]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_layers_follow_each_split(case):
    """Each op on blocks of every split a serve spec can give equals the op
    on the full leaves."""
    g = torch.Generator().manual_seed(3)
    mesh = Mesh(("data", "model"), (1, 4))
    x = torch.randn(3, 1, 16, generator=g)
    col, row, whole1 = (None, "model"), ("model", None), ("model",)
    dt = torch.float32

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    if case.startswith("embed"):
        table = rnd(24, 16)
        spec = (None, "model") if case == "embed_d" else ("model", None)
        ids = torch.tensor([[0, 23, 7], [12, 5, 18]])
        w = _blocks(table, spec, mesh)
        got, want = L.embed_lookup(w, ids), table[ids]
    elif case.startswith("dense"):
        p = {"w": rnd(16, 8), "b": rnd(8)}
        spec = col if case == "dense_col_bias" else row
        bp = {"w": _blocks(p["w"], spec, mesh), "b": _blocks(p["b"], whole1, mesh)}
        got, want = L.dense(bp, x, dt), L.dense(p, x, dt)
    elif case == "layernorm":
        p = {"scale": rnd(16), "bias": rnd(16)}
        bp = {k: _blocks(v, whole1, mesh) for k, v in p.items()}
        got = L.apply_norm(bp, x, norm_type="layernorm")
        want = L.apply_norm(p, x, norm_type="layernorm")
    else:
        kind = "gelu" if case == "gelu_pair" else "swiglu"
        p = L.mlp_init(g, 16, 32, mlp_type=kind, device="cpu")
        for q in p.values():
            if "b" in q:
                q["b"] = rnd(*q["b"].shape)
        specs = {"gate": col, "up": col, "in": col, "down": row, "out": row}
        bp = {k: {"w": _blocks(v["w"], specs[k], mesh),
                  **({"b": _blocks(v["b"], whole1, mesh)} if "b" in v else {})}
              for k, v in p.items()}
        if case == "swiglu_unpaired":  # a down projection kept whole: no pair
            bp["down"] = p["down"]
        got, want = L.mlp(bp, x, mlp_type=kind, compute_dtype=dt), L.mlp(p, x, mlp_type=kind,
                                                                          compute_dtype=dt)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_serve_layout_survives_with_mesh():
    tcfg, params, _, _ = _case("qwen2-72b")
    lay = layout_for(params, data_mesh(1, 2), mode="serve")
    other = data_mesh(2, 4)
    moved = lay.with_mesh(other)
    assert moved.mode == "serve" and moved.mesh == other
    assert moved.specs == layout_for(params, other, mode="serve").specs
    wq = moved.specs["layers"][0]["attn"]["wq"]["w"]
    assert wq == param_pspec(("layers", 0, "attn", "wq", "w"), tuple(params["layers"][0]
                                                                      ["attn"]["wq"]["w"].shape),
                             other, "serve") == (None, "model")
    assert layout_for(params, other).with_mesh(data_mesh(1, 2)).mode == "train"


def test_serve_blocks_refused_outside_the_decode_step():
    tcfg, params, inputs, _ = _case("qwen3")
    mesh = data_mesh(1, 2)
    tree = shard_tree(params, layout_for(params, mesh, mode="serve"))
    tb = tbuild(tcfg, make_pctx(mesh, device="cpu", impl="torch"))
    state = tb.init_serve_state(B, MAX_LEN, "cpu")
    with pytest.raises(RuntimeError, match="unbound"):
        tb.prefill_chunk(tree, torch.from_numpy(inputs["tokens"]), state,
                         torch.full((B,), S_TEXT, dtype=torch.int32))
    plain = tbuild(tcfg, make_pctx(data_mesh(1, 4), device="cpu", impl="torch"))
    with pytest.raises(ValueError, match="need a context over it"):
        plain.decode_step(tree, torch.zeros(B, dtype=torch.int32),
                          plain.init_serve_state(B, MAX_LEN, "cpu"))


def test_serve_blocks_are_bound_once():
    """The decode step binds the tree's blocks to its context's transport
    in place on the first step and leaves them so; another context over
    the same mesh is refused until the tree is cut again."""
    tcfg, params, inputs, _ = _case("qwen3")
    mesh = data_mesh(1, 2)
    got = _serve_run(tcfg, params, inputs, mesh)
    comm = got["pctx"].storage
    leaves = [x for x in tree_leaves(got["tree"]) if isinstance(x, ServeBlocks)]
    assert leaves and all(x.comm is comm for x in leaves)
    other = tbuild(tcfg, make_pctx(mesh, device="cpu", impl="torch", global_batch=B))
    with pytest.raises(ValueError, match="another context"):
        other.decode_step(got["tree"], torch.zeros(B, dtype=torch.int32),
                          other.init_serve_state(B, MAX_LEN, "cpu"))
    fresh = shard_tree(params, got["layout"])
    other.decode_step(fresh, torch.zeros(B, dtype=torch.int32),
                      other.init_serve_state(B, MAX_LEN, "cpu"))
    assert all(x.comm is other.pctx.storage for x in tree_leaves(fresh)
               if isinstance(x, ServeBlocks))


def test_serve_decode_on_gloo_groups_matches_jax(tmp_path):
    """Gloo groups of (1, 2) and (2, 2) ranks, spawned together: each rank
    holds its blocks only (checked against the rule's), prefills its data
    rank's rows and decodes them greedily; every rank's logits against the
    JAX rows of its data rank, the tokens equal, its ledger against
    ``serve_comm_bytes``."""
    from _serve_pg_worker import run

    models = sorted(MODELS)
    for model in models:
        tcfg, params, inputs, _ = _case(model)
        np.savez(tmp_path / f"{model}.npz", **inputs)
        torch.save(dataclasses.asdict(tcfg), tmp_path / f"{model}_cfg.pt")
        torch.save(params, tmp_path / f"{model}_params.pt")
    ctx = mp.get_context("spawn")
    groups = {shape: [ctx.Process(target=run, args=(
        r, shape, str(tmp_path / f"init{shape[0]}x{shape[1]}"), str(tmp_path), models,
        str(tmp_path / f"{shape[0]}x{shape[1]}_rank{r}.npz")))
        for r in range(shape[0] * shape[1])] for shape in ((1, 2), (2, 2))}
    procs = [p for g in groups.values() for p in g]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for (D, P), members in groups.items():
        mesh = data_mesh(D, P)
        for r in range(len(members)):
            res = np.load(tmp_path / f"{D}x{P}_rank{r}.npz")
            d = mesh.coords(r)["data"]
            rows = slice(d * B // D, (d + 1) * B // D)
            for model in models:
                tcfg, params, _, want = _case(model)
                label = f"gloo {D}x{P} rank {r} {model}"
                np.testing.assert_array_equal(res[f"{model}/tokens"], want["tokens"][rows],
                                              err_msg=label)
                np.testing.assert_allclose(res[f"{model}/logits"], want["logits"][rows],
                                           err_msg=label, **MODEL_TOL)
                assert res[f"{model}/blocks_ok"], label
                layout = layout_for(params, mesh, mode="serve")
                assert int(res[f"{model}/held"]) == state_bytes(layout, r), label
                closed = serve_comm_bytes(layout, tcfg, B // D)
                for cls in ("tp", "link", "data"):
                    np.testing.assert_array_equal(res[f"{model}/{cls}"],
                                                  [closed[cls]["fwd"], closed[cls]["bwd"]],
                                                  err_msg=f"{label} {cls}")

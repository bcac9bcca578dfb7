"""The encoder-decoder, SSM and hybrid decode steps under serve storage
(``repro_torch.sharding``'s ``mode="serve"`` layout, the reference's
Megatron layout for decode): ``encdec_decode_step``, ``mamba_decode_step``
and ``rg_decode_step`` on ``ServeBlocks`` leaves, each rank's blocks
resident, with the tensor-parallel collectives of ``models/layers.py``; the
recurrent state split by its width over ``model`` and the caches by
sequence, as ``serve_state_shardings`` gives them.

* reduced whisper-base, falcon-mamba-7b and recurrentgemma-2b, parameters
  from the JAX ``init`` carried across with ``from_jax_params``, float32,
  fed the same seeded tokens over the virtual (1, 2), (1, 4) and (2, 2)
  meshes: each step's logits against the JAX package at SP 1 at
  ``MODEL_TOL``, their argmax equal.  falcon-mamba and recurrentgemma are
  held to the JAX ``decode_step``; whisper to the JAX forward pass, teacher
  forced, since the JAX decode step reads the encoder causally (ROADMAP
  queue 3 item 9, which the port fixes).  recurrentgemma's ring buffer of
  16 slots is decoded past its wrap.  Each rank's blocks equal
  ``cut_blocks`` of the full leaf by ``param_pspec(mode="serve")``, and
  every step's ledger equals the family's closed form in every class,
  exactly;
* recurrentgemma with whole parameters at ``sp_degree`` 2 and 4 (no mesh),
  past the same wrap: the writing rank changes there;
* the widths make each of the rule's splits that do not line up with the
  state happen: falcon-mamba's ``[x | z]`` (N 4, R + 2N 16, so ``x_proj``
  splits by its 16 outputs and ``A_log`` by its 4 columns) at model 2 and
  4, layer by layer; recurrentgemma's 3 heads of 8 against a model size of
  2 and 4 (``wq`` split inside a head);
* the state: every leaf read back as the global state is the port's
  replicated SP-1 state, and each rank of (2, 2) and (1, 4) holds the
  block of it that ``serve_state_shardings`` gives;
* the same decodes on gloo groups of (1, 2) and (2, 2) spawned ranks
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
from test_torch_encdec import _jax_forward_logits
from test_torch_serve_storage import _check_blocks

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.models import build_model as jbuild
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext
from repro_torch.launch.mesh import data_mesh, make_pctx
from repro_torch.models import mamba as M
from repro_torch.models.convert import from_jax_params
from repro_torch.models.encdec import encdec_serve_comm_bytes
from repro_torch.models.layers import ONE_RANK
from repro_torch.models.mamba import mamba_serve_comm_bytes
from repro_torch.models.registry import build_model as tbuild
from repro_torch.models.rglru import rg_serve_comm_bytes
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sharding import (
    ServeBlocks,
    bind_serve,
    block_index,
    cut_blocks,
    layout_for,
    serve_state_shardings,
    shard_tree,
    state_bytes,
)

# (arch, overrides): small widths at which every split of the text happens
MODELS = {
    "whisper": ("whisper-base", dict(n_layers=2, vocab_size=97)),
    "mamba": ("falcon-mamba-7b", dict(n_layers=2, d_model=16, ssm_state=4, dt_rank=8,
                                      vocab_size=97)),
    "rg": ("recurrentgemma-2b", dict(n_layers=5, d_model=24, n_heads=3, n_kv_heads=1,
                                     d_head=8, d_ff=48, lru_width=24, window=16,
                                     vocab_size=97)),
}
CLOSED = {"encdec": encdec_serve_comm_bytes, "ssm": mamba_serve_comm_bytes,
          "hybrid": rg_serve_comm_bytes}
MESHES = [(1, 2), (1, 4), (2, 2)]
B, STEPS, MAX_LEN = 4, 20, 32
SPAWN_TIMEOUT_S = 90


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CASES = {}


def _case(model):
    """``(tcfg, params, inputs, want)``: the port's serving parameters from
    the JAX init, the tokens fed (``inputs["feed"] (B, STEPS)``, whisper's
    ``inputs["frames"]``) and the JAX logits at SP 1 (``want["logits"]``)
    and their argmax (``want["tokens"]``)."""
    if model not in _CASES:
        name, over = MODELS[model]
        jcfg, tcfg = JARCHS[name].reduced(**over), TARCHS[name].reduced(**over)
        jb = jbuild(jcfg, JPctx(mesh=None, impl="xla"))
        jparams = jb.init(jax.random.PRNGKey(5))
        rng = np.random.default_rng(len(model))
        feed = rng.integers(0, tcfg.vocab_size, (B, STEPS)).astype(np.int32)
        inputs = dict(feed=feed, max_len=np.asarray(MAX_LEN))
        if tcfg.family == "encdec":
            frames = rng.standard_normal((B, tcfg.enc_seq, tcfg.d_model)).astype(np.float32)
            inputs["frames"] = frames
            logits = _jax_forward_logits(jb, jparams, frames, feed)
        else:
            step, state, rows = jax.jit(jb.decode_step), jb.init_serve_state(B, MAX_LEN), []
            for t in range(STEPS):
                out, state = step(jparams, jnp.asarray(feed[:, t]), state)
                rows.append(np.asarray(out))
            logits = np.stack(rows, 1)
        params = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
        _CASES[model] = (tcfg, params, inputs, dict(logits=logits, tokens=logits.argmax(-1)))
    return _CASES[model]


def _decode(bundle, tree, inputs, params, steps=STEPS):
    """The state (encoded with the whole ``params`` for whisper), then the
    tokens fed through ``bundle.decode_step`` on ``tree``: the logits ``(B,
    steps, V)``, each step's ledger (``[]`` without a mesh) and the state."""
    state = bundle.init_serve_state(B, MAX_LEN, "cpu")
    if "frames" in inputs:
        bundle.encode(params, torch.from_numpy(inputs["frames"]), state)
    storage = bundle.pctx.storage
    rows, ledgers = [], []
    for t in range(steps):
        if storage is not None:
            storage.ledger.reset()
        logits, state = bundle.decode_step(tree, torch.from_numpy(inputs["feed"][:, t]), state)
        if storage is not None:
            ledgers.append({c: dict(v) for c, v in storage.ledger.class_bytes.items()})
        rows.append(logits.numpy())
    return np.stack(rows, 1), ledgers, state


def _serve_run(model, mesh):
    tcfg, params, inputs, _ = _case(model)
    pctx = make_pctx(mesh, device="cpu", impl="torch", global_batch=B, layout=tcfg.layout)
    bundle = tbuild(tcfg, pctx)
    layout = layout_for(params, mesh, mode="serve")
    tree = shard_tree(params, layout)
    logits, ledgers, state = _decode(bundle, tree, inputs, params)
    return dict(logits=logits, ledgers=ledgers, state=state, layout=layout, tree=tree,
                pctx=pctx)


def _check_bytes(ledgers, layout, cfg, rows):
    want = CLOSED[cfg.family](layout, cfg, rows)
    assert want["tp"]["fwd"] > 0 and want["data"]["fwd"] == 0
    for got in ledgers:
        assert set(got) <= set(want)
        for cls in want:
            assert got.get(cls, {"fwd": 0.0, "bwd": 0.0}) == want[cls], cls


@pytest.mark.parametrize("mesh_shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_serve_decode_matches_jax(model, mesh_shape):
    tcfg, params, _, want = _case(model)
    got = _serve_run(model, data_mesh(*mesh_shape))
    np.testing.assert_allclose(got["logits"], want["logits"], **MODEL_TOL)
    np.testing.assert_array_equal(got["logits"].argmax(-1), want["tokens"])
    _check_blocks(params, got["tree"], got["layout"])
    _check_bytes(got["ledgers"], got["layout"], tcfg, B // got["pctx"].data_degree)


def test_splits_that_do_not_line_up_with_the_state():
    """The widths make the rule split each leaf the text names off the
    state's dim, at model 2 and 4."""
    _, mparams, _, _ = _case("mamba")
    rcfg, rparams, _, _ = _case("rg")
    for G in (2, 4):
        s = layout_for(mparams, data_mesh(1, G), mode="serve").specs["layers"][0]
        assert s["in_proj"]["w"] == s["x_proj"]["w"] == s["A_log"] == (None, "model")
        assert mparams["layers"][0]["x_proj"]["w"].shape[1] == 16
        a = layout_for(rparams, data_mesh(1, G), mode="serve").specs["supers"][0]["attn"]["attn"]
        assert a["wq"]["w"] == a["wk"]["w"] == (None, "model") and rcfg.n_heads % G


@pytest.mark.parametrize("sp", [2, 4])
def test_rg_whole_params_at_sp_match_jax_past_the_wrap(sp):
    """recurrentgemma with whole parameters at SP 2 and 4 on the virtual
    ring: the ring buffer's 16 slots sequence-sharded, the recurrent state
    whole; 20 steps, so the write moves from the last rank back to rank 0."""
    tcfg, params, inputs, want = _case("rg")
    bundle = tbuild(tcfg, ParallelContext(impl="torch", device="cpu", sp_degree=sp,
                                          layout=tcfg.layout))
    logits, _, state = _decode(bundle, params, inputs, params)
    assert state["k"].shape[1:3] == (sp * B, tcfg.window // sp)
    assert state["rec_h"].shape[2:] == (B, tcfg.lru_width)
    np.testing.assert_allclose(logits, want["logits"], **MODEL_TOL)
    np.testing.assert_array_equal(logits.argmax(-1), want["tokens"])
    # every slot written in ring order: slot s holds the last position p < 20 with p % 16 == s
    pos = state["pos"].reshape(sp, B, -1).transpose(0, 1).reshape(B, -1)
    slots = np.arange(tcfg.window)
    np.testing.assert_array_equal(pos.numpy(), np.broadcast_to(
        np.where(slots < STEPS - tcfg.window, slots + tcfg.window, slots), pos.shape))


@pytest.mark.parametrize("G", [2, 4])
def test_mamba_layer_on_misaligned_blocks(G):
    """One falcon-mamba layer on serve blocks over a model axis of ``G``
    (``[x | z]`` split so that at G = 2 rank 0 holds all of x and rank 1 all
    of z; ``x_proj`` by its outputs, ``A_log`` by N), its state split by
    ``d_inner``, against the layer on whole leaves and the whole state."""
    tcfg, params, _, _ = _case("mamba")
    p = params["layers"][1]
    di, N, K = tcfg.d_inner, tcfg.ssm_state, tcfg.ssm_conv
    mesh = data_mesh(1, G)
    pctx = make_pctx(mesh, device="cpu", impl="torch")
    layout = layout_for(params, mesh, mode="serve")
    blocks = shard_tree(params, layout)["layers"][1]
    if G == 2:
        w = blocks["in_proj"]["w"].blocks
        assert torch.equal(w[0], p["in_proj"]["w"][:, :di])
        assert torch.equal(w[1], p["in_proj"]["w"][:, di:])
    bind_serve(blocks, pctx.storage)
    g = torch.Generator().manual_seed(G)
    x = torch.randn(B, 1, tcfg.d_model, generator=g)
    ssm = torch.randn(B, di, N, generator=g)
    conv = torch.randn(B, K - 1, di, generator=g)
    want = M.mamba_layer_decode(p, x, ssm[None], conv[None], cfg=tcfg, tp=ONE_RANK)

    pctx.storage.ledger.reset()
    got = M.mamba_layer_decode(blocks, x, ssm.unflatten(1, (G, -1)).movedim(1, 0),
                               conv.unflatten(2, (G, -1)).movedim(2, 0), cfg=tcfg,
                               tp=pctx.storage)
    torch.testing.assert_close(got[0], want[0], **MODEL_TOL)
    torch.testing.assert_close(got[1].movedim(0, 1).flatten(1, 2), want[1][0], **MODEL_TOL)
    torch.testing.assert_close(got[2].movedim(0, 2).flatten(2, 3), want[2][0], **MODEL_TOL)
    # the layer's bytes: the closed form of a one-layer tree less that of none
    base = {k: v for k, v in params.items() if k != "layers"}
    one, none = ({**base, "layers": layers} for layers in (params["layers"][1:], []))
    want_tp = (mamba_serve_comm_bytes(layout_for(one, mesh, mode="serve"), tcfg, B)["tp"]["fwd"]
               - mamba_serve_comm_bytes(layout_for(none, mesh, mode="serve"), tcfg,
                                        B)["tp"]["fwd"])
    assert pctx.storage.ledger.class_bytes["tp"]["fwd"] == want_tp > 0


def _global(x, spec, P):
    """A state leaf in the port's layout (``(..., P*B, ..., S/P, ...)``, the
    ranks rank-major in its batch dim) as the global leaf of ``spec``."""
    b, s = spec.index("data"), spec.index("model")
    return x.unflatten(b, (P, -1)).movedim(b, s).flatten(s, s + 1)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_state_layout_agrees_with_serve_state_shardings(model, mesh_shape):
    """Each leaf of the state after the decode, read back as the global
    leaf, is the port's replicated SP-1 state's, and rank (d, m)'s rows of
    it (model rank m's, data rank d's part of them) are the block of that
    global leaf which ``serve_state_shardings`` gives it: the recurrent
    state by its width, the caches by sequence."""
    tcfg, params, inputs, _ = _case(model)
    mesh = data_mesh(*mesh_shape)
    P, D = mesh.shape["model"], mesh.shape["data"]
    got = _serve_run(model, mesh)
    state = got["state"]
    _, _, ref = _decode(tbuild(tcfg, ParallelContext(impl="torch", device="cpu")), params,
                        inputs, params)
    specs = serve_state_shardings(state, mesh, got["pctx"], tcfg)
    split = {"encdec": ("k", "v", "pos", "xk", "xv", "enc_pos"), "ssm": ("ssm", "conv"),
             "hybrid": ("rec_h", "rec_conv", "tail_h", "tail_conv", "k", "v", "pos")}
    assert set(split[tcfg.family]) == set(state) - {"len"}
    if "len" in state:
        assert specs["len"] == ("data",) and torch.equal(state["len"], ref["len"])
    for key in split[tcfg.family]:
        spec = specs[key]
        glob = _global(state[key], spec, P)
        torch.testing.assert_close(glob, ref[key], **MODEL_TOL, msg=key)
        b = spec.index("data")
        for r in range(mesh.size):
            c = mesh.coords(r)
            block = cut_blocks(glob, spec, mesh)[block_index(spec, mesh, r)]
            mine = state[key].unflatten(b, (P, D, -1)).select(b, c["model"]).select(b, c["data"])
            assert torch.equal(block, mine), (key, r)


def test_serve_decode_on_gloo_groups_matches_jax(tmp_path):
    """Gloo groups of (1, 2) and (2, 2) ranks, spawned together: each rank
    holds its blocks only (checked against the rule's), encodes its shard
    of whisper's frames, decodes its data rank's rows fed the same tokens;
    every rank's logits against the JAX rows of its data rank, their argmax
    equal, its ledger against the family's closed form."""
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
                np.testing.assert_allclose(res[f"{model}/logits"], want["logits"][rows],
                                           err_msg=label, **MODEL_TOL)
                np.testing.assert_array_equal(res[f"{model}/tokens"], want["tokens"][rows],
                                              err_msg=label)
                assert res[f"{model}/blocks_ok"], label
                layout = layout_for(params, mesh, mode="serve")
                assert int(res[f"{model}/held"]) == state_bytes(layout, r), label
                closed = CLOSED[tcfg.family](layout, tcfg, B // D)
                for cls in ("tp", "link", "data"):
                    np.testing.assert_array_equal(res[f"{model}/{cls}"],
                                                  [closed[cls]["fwd"], closed[cls]["bwd"]],
                                                  err_msg=f"{label} {cls}")


def test_serve_blocks_of_every_family_are_bound_and_refused_unbound():
    """Each family's decode step binds its tree's blocks to the context's
    transport; blocks reaching the encoder (which takes whole parameters)
    are refused with the message that names every decode step."""
    tcfg, params, inputs, _ = _case("whisper")
    mesh = data_mesh(1, 2)
    tree = shard_tree(params, layout_for(params, mesh, mode="serve"))
    bundle = tbuild(tcfg, make_pctx(mesh, device="cpu", impl="torch", global_batch=B))
    state = bundle.init_serve_state(B, MAX_LEN, "cpu")
    with pytest.raises(RuntimeError, match="rg_decode_step"):
        bundle.encode(tree, torch.from_numpy(inputs["frames"]), state)
    for model in ("mamba", "rg"):
        tcfg, params, inputs, _ = _case(model)
        tree = shard_tree(params, layout_for(params, mesh, mode="serve"))
        bundle = tbuild(tcfg, make_pctx(mesh, device="cpu", impl="torch", global_batch=B))
        bundle.decode_step(tree, torch.from_numpy(inputs["feed"][:, 0]),
                           bundle.init_serve_state(B, MAX_LEN, "cpu"))
        leaves = [x for x in tree_leaves(tree) if isinstance(x, ServeBlocks)]
        assert leaves and all(x.comm is bundle.pctx.storage for x in leaves)

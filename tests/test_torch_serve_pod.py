"""Every family's decode step on serve storage over the pod mesh ``(pod,
data, model)``, as the JAX multi-pod decode dry run compiles it: the
parameters in ``ServeBlocks`` by ``param_pspec(mode="serve")`` (split over
``model``, replicated over ``pod`` and ``data``), the caches split by
sequence over ``("pod", "model")`` and the recurrent state by its width
over the same axes, ordered model-major (``layers.state_tp``: rank ``(p,
m)`` holds width slice ``m * pods + p``, a part of its own model block).

* reduced qwen3, olmo, pixtral, qwen3-moe, llama4 (capacity factor E / K:
  nothing drops), whisper, falcon-mamba and recurrentgemma, the fixtures of
  ``test_torch_serve_storage.py`` and ``test_torch_serve_families.py``,
  over the virtual (2, 1, 2) and (2, 2, 2) meshes: each step's logits
  against the JAX package at SP 1 at ``MODEL_TOL``, their argmax equal;
  each rank's blocks ``cut_blocks`` of the full leaf by the port's rule,
  whose specs equal the JAX ``param_pspec(mode="serve")`` on an
  ``AbstractMesh`` of the same shape; the state's specs equal the JAX
  ``serve_state_shardings``; the state read back as the global state
  equals the replicated decode's (whole parameters at the same SP degree),
  each rank holding the reference's pod-major block of a cache and the
  model-major slice of a recurrent leaf; every step's ledger equal to the
  family's closed form, exactly.  recurrentgemma's 20 steps wrap its ring
  buffer of 16 slots;
* both branches of ``moe.ep_size``: experts over every SP rank (qwen3-moe's
  8 on 4 ranks, a model block holding one EP slice a pod) and over
  ``model`` alone (llama4 with 4 experts on (2, 1, 4)), no expert stack
  gathered, the inner ring's sum in the ledger's ``"intra"`` class; the EP
  slice each process-group rank runs, a part of its own block, and the
  refusal of blocks that are not split by expert;
* global batch 1 on (2, 2, 2), which drops the data axis as the
  reference's long_500k cell does;
* the same decode on a gloo group of (2, 1, 2) spawned ranks
  (``_serve_pg_worker.py``) for qwen3-moe, falcon-mamba and
  recurrentgemma, each rank holding its blocks and its slice of the state
  only.
"""

import dataclasses
import multiprocessing as mp
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import test_torch_serve_families as SF
import test_torch_serve_storage as ST
import torch
from jax.sharding import AbstractMesh
from test_torch_data_parallel import MODEL_TOL

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.launch import mesh as jmesh
from repro.models import build_model as jbuild
from repro.sharding import rules as jrules
from repro_torch.core.api import ParallelContext
from repro_torch.launch.mesh import data_mesh, make_pctx
from repro_torch.models import moe as MOE
from repro_torch.models.registry import build_model as tbuild
from repro_torch.sharding import (
    STACKED,
    ServeBlocks,
    block_index,
    cut_blocks,
    layout_for,
    serve_state_shardings,
    shard_tree,
    state_bytes,
)

# the EP branch where the experts shard over model alone: 4 experts on the
# (2, 1, 4) mesh's 8 SP ranks (ST's table, keyed apart from its models)
ST.MODELS.setdefault("llama4-e4", ("llama4-scout-17b-a16e", {"n_experts": 4}))
STORAGE = ("qwen3", "olmo", "pixtral", "qwen3-moe", "llama4")
FAMILY = ("whisper", "mamba", "rg")
MESHES = [(2, 1, 2), (2, 2, 2)]
MESH_IDS = [f"{p}x{d}x{m}" for p, d, m in MESHES]
# (batch dim, split dim) of each state leaf that serve_state_shardings splits
STATE_DIMS = {"k": (1, 2), "v": (1, 2), "pos": (0, 1), "xk": (1, 2), "xv": (1, 2),
              "enc_pos": (0, 1), "ssm": (1, 2), "conv": (1, 3), "rec_h": (2, 3),
              "rec_conv": (2, 4), "tail_h": (1, 2), "tail_conv": (1, 3)}
RECURRENT = ("ssm", "conv", "rec_h", "rec_conv", "tail_h", "tail_conv")
GLOO_MODELS = ("mamba", "qwen3-moe", "rg")
SPAWN_TIMEOUT_S = 90


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(model):
    """``(jcfg, tcfg, params, inputs, want, feed)`` from the shared
    fixtures; ``feed (B, steps)`` the tokens each decode step takes (the
    JAX greedy chain after a prefill, or the fixture's seeded tokens)."""
    if model in FAMILY:
        tcfg, params, inputs, want = SF._case(model)
        name, over = SF.MODELS[model]
        return JARCHS[name].reduced(**over), tcfg, params, inputs, want, inputs["feed"]
    tcfg, params, inputs, want = ST._case(model)
    return ST._configs(model)[0], tcfg, params, inputs, want, want["tokens"]


def _drive(bundle, tree, params, inputs, feed, rows):
    """``feed[rows]`` through ``bundle.decode_step`` on ``tree`` from the
    start of ``inputs``' rows: the prompt prefilled, whisper's frames
    encoded (both with the whole ``params``) or a fresh state.  Returns the
    logits ``(b, steps, V)``, each step's ledger (``[]`` without a mesh)
    and the state."""
    b = rows.stop - rows.start
    state = bundle.init_serve_state(b, int(inputs["max_len"]), "cpu")
    if "tokens" in inputs:
        prefix = inputs.get("prefix")
        _, state = bundle.prefill(params, torch.from_numpy(inputs["tokens"][rows]),
                                  torch.from_numpy(inputs["pos"][rows]), state,
                                  None if prefix is None else torch.from_numpy(prefix[rows]))
    elif "frames" in inputs:
        bundle.encode(params, torch.from_numpy(inputs["frames"][rows]), state)
    storage = bundle.pctx.storage
    out, ledgers = [], []
    for t in range(feed.shape[1]):
        if storage is not None:
            storage.ledger.reset()
        logits, state = bundle.decode_step(tree, torch.from_numpy(feed[rows, t]), state)
        if storage is not None:
            ledgers.append({c: dict(v) for c, v in storage.ledger.class_bytes.items()})
        out.append(logits.numpy())
    return np.stack(out, 1), ledgers, state


def _run(model, mesh_shape, batch=ST.B):
    """The decode of ``model``'s first ``batch`` rows on serve blocks over
    the virtual ``mesh_shape`` and, fed the same tokens, the replicated
    decode (whole parameters, the same SP degree and pods)."""
    jcfg, tcfg, params, inputs, want, feed = _fixture(model)
    pods, D, G = mesh_shape
    mesh = data_mesh(D, G, pods)
    rows = slice(0, batch)
    pctx = make_pctx(mesh, device="cpu", impl="torch", global_batch=batch, layout=tcfg.layout)
    layout = layout_for(params, mesh, mode="serve")
    tree = shard_tree(params, layout)
    logits, ledgers, state = _drive(tbuild(tcfg, pctx), tree, params, inputs, feed, rows)
    plain = tbuild(tcfg, ParallelContext(impl="torch", device="cpu", sp_degree=pods * G,
                                         pods=pods, layout=tcfg.layout))
    _, _, ref = _drive(plain, params, params, inputs, feed, rows)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, want=want, rows=rows, mesh=mesh,
                pctx=pctx, layout=layout, tree=tree, logits=logits, ledgers=ledgers,
                state=state, ref=ref)


def _global(x, key, n):
    """A state leaf in the port's layout (``n`` row blocks in its batch dim,
    each a block of its split dim in order) as the global leaf."""
    b, s = STATE_DIMS[key]
    return x.unflatten(b, (n, -1)).movedim(b, s).flatten(s, s + 1)


def _key(k):
    return getattr(k, "key", getattr(k, "name", None))


def _jax_mesh(mesh):
    return AbstractMesh(mesh.axis_sizes, mesh.axis_names)


def _check_specs_against_jax(got):
    """The layout's specs equal the JAX ``param_pspec(mode="serve")``, and
    the state's the JAX ``serve_state_shardings``, on an ``AbstractMesh``
    of the same shape (a stacked JAX leaf against each of the port's list
    entries, less its leading ``None``)."""
    jm, jcfg, batch = _jax_mesh(got["mesh"]), got["jcfg"], got["rows"].stop
    jb = jbuild(jcfg, JPctx(mesh=None, impl="xla"))
    shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [_key(k) for k in path]
        want = tuple(jrules.param_pspec(path, leaf.shape, jm, "serve"))
        at = next((i + 1 for i, k in enumerate(keys) if k in STACKED), None)
        entries = [keys] if at is None else [keys[:at] + [i] + keys[at:]
                                             for i in range(leaf.shape[0])]
        for port in entries:
            spec = got["layout"].specs
            for k in port:
                spec = spec[k]
            assert spec == (want if at is None else want[1:]), (port, spec, want)
            n += 1
    assert n > 0
    jstate = jax.eval_shape(lambda: jb.init_serve_state(batch, 32))
    jspecs = jrules.serve_state_shardings(jstate, jm, jmesh.make_pctx(jm, global_batch=batch),
                                          jcfg)
    tspecs = serve_state_shardings(got["state"], got["mesh"], got["pctx"], got["tcfg"])
    for path, sh in jax.tree_util.tree_flatten_with_path(jspecs)[0]:
        assert tspecs[_key(path[-1])] == tuple(sh.spec), _key(path[-1])
    return tspecs


def _check_state(got, specs):
    """The state read back globally equals the replicated decode's; rank
    ``(p, d, m)`` holds the reference's block of a cache (pod-major over
    the sequence axes) and width slice ``m * pods + p`` of a recurrent
    leaf, its data rank's rows."""
    mesh, state, ref = got["mesh"], got["state"], got["ref"]
    pods, D, G = (mesh.shape[a] for a in ("pod", "data", "model"))
    assert got["pctx"].data_degree in (1, D)
    D = got["pctx"].data_degree
    for key in set(state) & set(STATE_DIMS):
        b, s = STATE_DIMS[key]
        glob = _global(state[key], key, pods * G)
        want = ref[key] if key in RECURRENT else _global(ref[key], key, pods * G)
        if glob.is_floating_point():
            torch.testing.assert_close(glob, want, **MODEL_TOL, msg=key)
        else:
            assert torch.equal(glob, want), key
        spec = specs[key]
        for r in range(mesh.size):
            c = mesh.coords(r)
            d = c["data"] if D > 1 else 0
            if key in RECURRENT:
                j = c["model"] * pods + c["pod"]
                width = glob.shape[s] // (pods * G)
                block = glob.narrow(s, j * width, width)
                block = block.unflatten(b, (D, -1)).select(b, d)
            else:
                j = c["pod"] * G + c["model"]
                block = cut_blocks(glob, spec, mesh)[block_index(spec, mesh, r)]
            mine = state[key].unflatten(b, (pods * G, D, -1)).select(b, j).select(b, d)
            assert torch.equal(block, mine), (key, r)
    if "len" in state:
        assert torch.equal(state["len"], ref["len"])


def _check_bytes(ledgers, layout, cfg, rows):
    want = SF.CLOSED.get(cfg.family, ST.serve_comm_bytes)(layout, cfg, rows)
    assert want["tp"]["fwd"] > 0 and want["data"]["fwd"] == 0
    for got in ledgers:
        assert set(got) <= set(want)
        for cls in want:
            assert got.get(cls, {"fwd": 0.0, "bwd": 0.0}) == want[cls], cls


def _check(got):
    want, rows = got["want"], got["rows"]
    np.testing.assert_allclose(got["logits"], want["logits"][rows], **MODEL_TOL)
    np.testing.assert_array_equal(got["logits"].argmax(-1), want["logits"][rows].argmax(-1))
    ST._check_blocks(got["params"], got["tree"], got["layout"])
    _check_state(got, _check_specs_against_jax(got))
    _check_bytes(got["ledgers"], got["layout"], got["tcfg"],
                 (rows.stop - rows.start) // got["pctx"].data_degree)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("model", sorted(STORAGE + FAMILY))
def test_serve_decode_on_the_pod_mesh_matches_jax(model, mesh_shape):
    got = _run(model, mesh_shape)
    _check(got)
    if model == "rg":  # 20 steps through 16 slots: slot s holds the last p with p % 16 == s
        W = got["tcfg"].window
        pos = _global(got["state"]["pos"], "pos", 4)
        slots = np.arange(W)
        np.testing.assert_array_equal(pos.numpy(), np.broadcast_to(
            np.where(slots < SF.STEPS - W, slots + W, slots), pos.shape))


@pytest.mark.parametrize("model", ["qwen3", "qwen3-moe", "mamba", "rg"])
def test_global_batch_one_drops_the_data_axis(model):
    got = _run(model, (2, 2, 2), batch=1)
    assert got["pctx"].data_degree == 1 and got["pctx"].data_axis is None
    _check(got)


EP_CASES = {"every_sp_rank": ("qwen3-moe", (2, 1, 2)), "model_only": ("llama4-e4", (2, 1, 4))}


@pytest.mark.parametrize("branch", sorted(EP_CASES))
def test_moe_both_ep_branches_move_no_expert_weight(branch, monkeypatch):
    """The experts over every SP rank (8 on 4: a model block of 4 holds
    one EP slice of 2 a pod) or over ``model`` alone (4 on (2, 1, 4)'s 8
    ranks: replicated over pods, the sum on the inner ring, class
    ``"intra"``); no expert stack is gathered."""
    model, shape = EP_CASES[branch]
    gathered = []
    whole = ServeBlocks.whole
    monkeypatch.setattr(ServeBlocks, "whole", lambda self: gathered.append(self.shape)
                        or whole(self))
    got = _run(model, shape)
    cfg, (pods, _, G) = got["tcfg"], shape
    n_ep = MOE.ep_size(cfg.n_experts, pods * G, pods)
    assert n_ep == {"every_sp_rank": pods * G, "model_only": G}[branch]
    _check(got)
    assert gathered and all(len(s) < 3 for s in gathered)
    classes = set().union(*got["ledgers"])
    assert ("intra" in classes) == (branch == "model_only")


@pytest.mark.parametrize("n_ep", [8, 4])
def test_ep_slice_of_each_rank_lies_in_its_block(n_ep):
    """On a process group of the (2, 1, 4) mesh, flat rank ``(pod q,
    model m)`` runs EP slice ``m * 2 + q`` (every SP rank) or ``m`` (model
    only), cut from its own block of the serve storage, equal to the
    whole stack's slice; blocks split otherwise are refused."""
    pods, G, E = 2, 4, 16
    mesh = data_mesh(1, G, pods)
    g = torch.Generator().manual_seed(n_ep)
    full = {k: torch.randn(E, 3, 5, generator=g) for k in ("wg", "wu", "wd")}
    for r in range(pods * G):
        q, m = divmod(r, G)
        pctx = SimpleNamespace(ring=SimpleNamespace(folded=False, rank=r), sp_degree=pods * G,
                               pods=pods)
        p = {k: ServeBlocks(cut_blocks(w, ("model", None, None), mesh)[m:m + 1],
                            ("model", None, None), mesh) for k, w in full.items()}
        index, *stacks = MOE._ep_slices(p, n_ep, pctx, torch.float32, "cpu")
        e = m * pods + q if n_ep == pods * G else m
        assert index.tolist() == [e]
        n = E // n_ep
        for w, k in zip(stacks, ("wg", "wu", "wd")):
            assert torch.equal(w[0], full[k][e * n:(e + 1) * n])
            assert w.untyped_storage().data_ptr() == p[k].blocks.untyped_storage().data_ptr()
        whole_p = MOE._ep_slices(full, n_ep, pctx, torch.float32, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(stacks, whole_p[1:]))
    bad = {k: ServeBlocks(cut_blocks(w, (None, "model", None), data_mesh(1, 3, pods)),
                          (None, "model", None), data_mesh(1, 3, pods)) for k, w in full.items()}
    with pytest.raises(ValueError, match="must lie in model block"):
        MOE._ep_slices(bad, n_ep, SimpleNamespace(ring=SimpleNamespace(folded=True),
                                                  sp_degree=pods * G, pods=pods),
                       torch.float32, "cpu")


def test_serve_decode_on_a_pod_gloo_group_matches_jax(tmp_path):
    """A gloo group of (2, 1, 2) spawned ranks: each rank holds its blocks
    only (the rule's), decodes every row and holds its slice of the state
    (the model-major slice of a recurrent leaf, the pod-major block of a
    cache); its logits against the JAX rows, their argmax equal, its
    ledger against the family's closed form, its state against the
    virtual mesh's."""
    from _serve_pg_worker import run

    shape = (2, 1, 2)
    for model in GLOO_MODELS:
        _, tcfg, params, inputs, _, _ = _fixture(model)
        np.savez(tmp_path / f"{model}.npz", **inputs)
        torch.save(dataclasses.asdict(tcfg), tmp_path / f"{model}_cfg.pt")
        torch.save(params, tmp_path / f"{model}_params.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, shape, str(tmp_path / "init"), str(tmp_path),
                                           GLOO_MODELS, str(tmp_path / f"rank{r}.npz")),
                         kwargs=dict(keep_state=True)) for r in range(4)]
    for p in procs:
        p.start()
    virtual = {model: _run(model, shape) for model in GLOO_MODELS}  # while the ranks run
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    mesh = data_mesh(1, 2, 2)
    for r in range(4):
        res = np.load(tmp_path / f"rank{r}.npz")
        c = mesh.coords(r)
        for model in GLOO_MODELS:
            got = virtual[model]
            tcfg, want, label = got["tcfg"], got["want"], f"gloo rank {r} {model}"
            np.testing.assert_allclose(res[f"{model}/logits"], want["logits"], err_msg=label,
                                       **MODEL_TOL)
            np.testing.assert_array_equal(res[f"{model}/logits"].argmax(-1),
                                          want["logits"].argmax(-1), err_msg=label)
            assert res[f"{model}/blocks_ok"], label
            assert int(res[f"{model}/held"]) == state_bytes(got["layout"], r), label
            closed = SF.CLOSED.get(tcfg.family, ST.serve_comm_bytes)(got["layout"], tcfg, ST.B)
            for cls in ("tp", "link", "data", "intra"):
                n = closed.get(cls, {"fwd": 0.0, "bwd": 0.0})
                np.testing.assert_array_equal(res[f"{model}/{cls}"], [n["fwd"], n["bwd"]],
                                              err_msg=f"{label} {cls}")
            for key in set(got["state"]) & set(STATE_DIMS):
                b, _ = STATE_DIMS[key]
                j = (c["model"] * 2 + c["pod"] if key in RECURRENT
                     else c["pod"] * 2 + c["model"])
                mine = got["state"][key].unflatten(b, (4, -1)).select(b, j)
                np.testing.assert_allclose(res[f"{model}/state/{key}"], mine.numpy(),
                                           err_msg=f"{label} {key}", **MODEL_TOL)

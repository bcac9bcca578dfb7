"""The port's sharding rules and FSDP storage against the JAX package's rules.

``param_pspec`` (train and serve mode), ``batch_shardings`` and
``serve_state_shardings`` are held to ``repro.sharding.rules`` on every
registered config (reduced) and on the meshes (2, 4), (4, 2), (16, 16) and
(2, 16, 16); the JAX side takes an ``AbstractMesh``, which needs no
devices.  The port's trees are lists of layers where the JAX trees stack
them, so a stacked leaf's spec is compared less its leading ``None``.  The
storage (``repro_torch.sharding``): ``shard_state`` then ``gather_params``
gives the tree back bit for bit, and the ledger's ``"data"`` class equals
``fsdp_comm_bytes``.  No tolerance: every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.launch import mesh as jmesh
from repro.models import build_model as jbuild
from repro.sharding import rules as jrules
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.launch.mesh import Mesh, make_pctx, make_production_mesh
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sharding import (
    assemble_blocks,
    block_index,
    cut_blocks,
    fsdp_comm_bytes,
    gather_params,
    layout_for,
    rules as trules,
    shard_state,
    spec_leaves,
    state_bytes,
)

MESHES = [(("data", "model"), (2, 4)), (("data", "model"), (4, 2)),
          (("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16))]
MESH_IDS = ["2x4", "4x2", "16x16", "2x16x16"]
STACKED = ("layers", "supers", "tail", "enc_layers", "dec_layers")


def _meshes(i):
    names, sizes = MESHES[i]
    return AbstractMesh(sizes, names), Mesh(names, sizes)


def _jax_shapes(name):
    jb = jbuild(JARCHS[name].reduced(), JPctx(mesh=None, impl="xla"))
    return jb, jax.eval_shape(jb.init, jax.random.PRNGKey(0))


def _key(k):
    return getattr(k, "key", getattr(k, "name", None))


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_param_pspec_matches_jax(name, mesh_i, mode):
    jm, tm = _meshes(mesh_i)
    _, shapes = _jax_shapes(name)
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [_key(k) for k in path]
        want = tuple(jrules.param_pspec(path, leaf.shape, jm, mode))
        stacked = any(k in STACKED for k in keys)
        if stacked:
            # the port's entry: the layer's index after the stack's key
            at = next(i for i, k in enumerate(keys) if k in STACKED) + 1
            port_path = tuple(keys[:at]) + (0,) + tuple(keys[at:])
            got = trules.param_pspec(port_path, leaf.shape[1:], tm, mode)
            assert want[0] is None
            want = want[1:]
        else:
            got = trules.param_pspec(tuple(keys), leaf.shape, tm, mode)
        assert got == want, (keys, leaf.shape, got, want)
        n += 1
    assert n > 0


def test_params_shardings_walks_the_ports_tree():
    """The port's own tree (lists of layers) gets the same specs as the JAX
    tree's stacked leaves."""
    from repro_torch.models.convert import from_jax_params

    jm, tm = _meshes(0)
    jb = jbuild(JARCHS["qwen3-1.7b"].reduced(), JPctx(mesh=None, impl="xla"))
    jparams = jb.init(jax.random.PRNGKey(0))
    jspecs = jrules.params_shardings(jparams, jm)
    tparams = from_jax_params(TARCHS["qwen3-1.7b"].reduced(),
                              jax.tree.map(np.asarray, jparams), device="cpu", training=True)
    tspecs = trules.params_shardings(tparams, tm)
    n = 0

    def walk(t, j, stacked, name):
        nonlocal n
        if isinstance(t, dict):
            assert set(t) == set(j), name
            for k in t:
                walk(t[k], j[k], stacked, f"{name}.{k}")
        elif isinstance(t, list):
            for i, sub in enumerate(t):
                walk(sub, j, True, f"{name}[{i}]")
        else:
            want = tuple(j.spec)
            assert t == (want[1:] if stacked else want), name
            n += 1

    walk(tspecs, jspecs, False, "")
    assert n == len(tree_leaves(tparams))


def _batch(B, S, enc=None, n_img=None):
    out = {"tokens": (B, S), "labels": (B, S), "positions": (B, S), "mask": (B, S),
           "lengths": (B,), "extra3d": (B, S, 8)}
    if enc:
        out["frames"] = (B, enc, 16)
    if n_img:
        out["patch_embeds"] = (B, n_img, 16)
    return out


@pytest.mark.parametrize("global_batch", [32, 1])
@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
def test_batch_shardings_match_jax(mesh_i, global_batch):
    """Every key's spec, with the data axis kept (32 divides) and dropped
    (a global batch of 1, long_500k's)."""
    jm, tm = _meshes(mesh_i)
    jp = jmesh.make_pctx(jm, global_batch=global_batch)
    tp = make_pctx(tm, global_batch=global_batch, device="cpu")
    assert tp.data_axis == jp.data_axis and tp.seq_spec() == jp.seq_spec()
    shapes = _batch(global_batch, 64, enc=32, n_img=4)
    jspecs = jrules.batch_shardings(
        {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}, jm, jp)
    tspecs = trules.batch_shardings({k: np.zeros(s, np.float32) for k, s in shapes.items()},
                                    tm, tp)
    for k in shapes:
        assert tspecs[k] == tuple(jspecs[k].spec), k


@pytest.mark.parametrize("mesh_i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("name", sorted(JARCHS))
def test_serve_state_shardings_match_jax(name, mesh_i):
    jm, tm = _meshes(mesh_i)
    jb, _ = _jax_shapes(name)
    state = jax.eval_shape(lambda: jb.init_serve_state(32, 64))
    jp = jmesh.make_pctx(jm, global_batch=32)
    tp = make_pctx(tm, global_batch=32, device="cpu")
    cfg = JARCHS[name].reduced()
    jspecs = jrules.serve_state_shardings(state, jm, jp, cfg)
    tstate = jax.tree.map(lambda s: np.zeros(s.shape, np.int8), state)
    tspecs = trules.serve_state_shardings(tstate, tm, tp, TARCHS[name].reduced())
    flat_j = jax.tree_util.tree_flatten_with_path(jspecs)[0]
    for path, sh in flat_j:
        t = tspecs
        for k in path:
            t = t[_key(k)]
        assert t == tuple(sh.spec), [_key(k) for k in path]


def test_data_group_and_production_meshes():
    for multi in (False, True):
        jm = AbstractMesh(jmesh.MULTI_POD_SHAPE if multi else jmesh.SINGLE_POD_SHAPE,
                          ("pod", "data", "model") if multi else ("data", "model"))
        tm = make_production_mesh(multi_pod=multi)
        assert tm.axis_names == jm.axis_names and tm.shape == dict(jm.shape)
        assert trules.data_group(tm) == jrules.data_group(jm)


@pytest.mark.parametrize("rank", range(8))
def test_rank_order_is_row_major(rank):
    """Rank ``d*P + m`` on (data, model); a ("pod", "data") entry indexes
    pod-major, as JAX lays a tuple of axes out."""
    m = Mesh(("pod", "data", "model"), (2, 2, 2))
    c = m.coords(rank)
    assert rank == c["pod"] * 4 + c["data"] * 2 + c["model"] and m.rank_of(c) == rank
    full = np.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), "model")
    got = cut_blocks(full, spec, m)[block_index(spec, m, rank)]
    row = c["pod"] * 2 + c["data"]
    want = full[row * 2:(row + 1) * 2, c["model"] * 3:(c["model"] + 1) * 3]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(assemble_blocks(cut_blocks(full, spec, m), spec, m), full)
    assert m.group(("data",), rank) == [r for r in range(8)
                                         if m.coords(r)["pod"] == c["pod"]
                                         and m.coords(r)["model"] == c["model"]]


MESH_CASES = [dict(data_degree=2, sp_degree=2), dict(data_degree=2, sp_degree=4),
              dict(data_degree=2, sp_degree=4, pods=2)]


@pytest.mark.parametrize("case", MESH_CASES, ids=["2x2", "2x4", "pods2x2x2"])
def test_shard_gather_round_trip_and_ledger(case):
    """``shard_state`` then ``gather_params`` is bitwise the tree; its
    backward gives the full gradient's blocks; the ledger's data class
    equals ``fsdp_comm_bytes`` a direction."""
    pctx = TPctx(device="cpu", impl="torch", **case)
    cfg = TARCHS["qwen3-moe-30b-a3b"].reduced(n_layers=1)
    params = tbuild(cfg, pctx).init(0, training=True)
    shards, layout = shard_state(params, pctx.mesh)
    for leaf in tree_leaves(shards):
        leaf.requires_grad_(True)
    comm = pctx.storage
    comm.ledger.reset()
    full = gather_params(shards, layout, comm)
    for a, b in zip(tree_leaves(full), tree_leaves(params)):
        assert torch.equal(a, b)
    weights = [torch.randn(x.shape, generator=torch.Generator().manual_seed(i))
               for i, x in enumerate(tree_leaves(params))]
    loss = sum((a * w).sum() for a, w in zip(tree_leaves(full), weights))
    grads = torch.autograd.grad(loss, tree_leaves(shards))
    for g, w, spec in zip(grads, weights, spec_leaves(layout.specs)):
        assert torch.equal(g, cut_blocks(w, spec, layout.mesh))
    want = fsdp_comm_bytes(layout)
    assert comm.ledger.class_bytes["data"] == pytest.approx(want, rel=1e-12)
    assert set(comm.ledger.class_bytes) == {"data"}
    # what one rank of a real mesh holds
    total = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    assert state_bytes(layout) < total


def test_layout_for_keeps_scalars_whole_and_moments_like_params():
    mesh = Mesh(("data", "model"), (2, 2))
    tree = {"params": {"w": torch.zeros(4, 8)},
            "opt": {"m": {"w": torch.zeros(4, 8)}, "step": torch.zeros((), dtype=torch.int32)},
            "step": torch.zeros((), dtype=torch.int32)}
    lay = layout_for(tree, mesh)
    assert lay.specs["params"]["w"] == lay.specs["opt"]["m"]["w"] == ("data", "model")
    assert lay.specs["opt"]["step"] is None and lay.specs["step"] is None

"""Int8 error-feedback compression (``optim/compress.py``), elastic
re-meshing (``runtime/elastic.py``), the cross-mesh checkpoint restore and
the ``distributed_check`` CLI, against the JAX package.

* ``quantize_int8`` bitwise equal to the JAX function (halves round to
  even in both);
* ``compressed_psum_ef`` over a virtual data view of 8 ranks against the
  JAX function under ``jax.vmap(..., axis_name="data")`` over 8 rows (no
  extra devices needed), five steps carrying the error feedback, within
  1e-6 (the same float32 operations; the int32 sum is exact);
* ``shrink_mesh`` shapes equal to the JAX function's (given a list of one
  repeated CPU device) for 1-16 ranks and model axes 1, 2, 3, 4, 8;
* ``reshard`` (2, 4) -> (1, 4) -> (3, 1) and a checkpoint saved on (2, 4)
  restored onto (4, 2), bitwise, on the virtual mesh (a gloo group's
  restore runs in the CLI's ``ckpt_mesh``);
* the CLI on 8 gloo ranks and on the virtual mesh, and the port of
  ``examples/train_distributed_ft.py``'s run (a failure at step 17, one
  restart, the loss falls).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jcompress
from repro.runtime import elastic as jelastic
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.core.collectives import VirtualRing
from repro_torch.launch.mesh import Mesh
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import compress as tcompress
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime.elastic import ElasticState, reshard, shrink_mesh
from repro_torch.sharding import layout_for, shard_tree, unshard_tree

ROOT = Path(__file__).resolve().parent.parent
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
               vocab_size=97, logits_chunk=16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 33)).astype(np.float32)
    halves = (np.arange(-20, 21, dtype=np.float32) + 0.5) / 20.5 * 127 / 127
    return {"normal": x, "scaled": x * 1e-3, "zeros": np.zeros((5,), np.float32),
            "halves": np.concatenate([halves, [1.0]]).astype(np.float32) * 20.5 / 127}


@pytest.mark.parametrize("name", sorted(_inputs()))
def test_quantize_int8_is_bitwise_jax(name):
    x = _inputs()[name]
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    tq, ts = tcompress.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tcompress.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jcompress.dequantize_int8(jq, js)))


def test_compressed_psum_ef_matches_jax_under_vmap():
    rng = np.random.default_rng(0)
    g_all = {"w": rng.standard_normal((8, 64)).astype(np.float32),
             "b": rng.standard_normal((8, 3, 5)).astype(np.float32) * 1e-2}
    step = jax.jit(jax.vmap(lambda g, e: jcompress.compressed_psum_ef(g, e, axis_name="data"),
                            axis_name="data"))
    je = jax.tree.map(jnp.zeros_like, g_all)
    axis = VirtualRing(8, "cpu", link_class="data")
    tg = {k: torch.from_numpy(v) for k, v in g_all.items()}
    te = tcompress.init_error_feedback(tg)
    for _ in range(5):
        jm, je = step(g_all, je)
        tm, te = tcompress.compressed_psum_ef(tg, te, axis=axis)
        for k in g_all:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), atol=1e-6, rtol=0)
            np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]), atol=1e-6, rtol=0)
    # int32 payload and one absmax a leaf a step, per rank and direction
    assert axis.class_bytes["data"]["fwd"] > 0


@pytest.mark.parametrize("model_axis", [1, 2, 3, 4, 8])
def test_shrink_mesh_matches_jax(model_axis):
    dev = jax.devices()[0]
    for n in range(1, 17):
        want = jelastic.shrink_mesh([dev] * n, model_axis=model_axis)
        got = shrink_mesh(n, model_axis=model_axis)
        assert got.shape == dict(want.shape), (n, model_axis)
        assert shrink_mesh(list(range(n)), model_axis=model_axis) == got


def _state():
    """A reduced qwen3's parameters and AdamW moments (seeded, nonzero)."""
    pctx = TPctx(device="cpu", impl="torch")
    params = tbuild(TARCHS["qwen3-1.7b"].reduced(**REDUCED), pctx).init(0, training=True)
    g = torch.Generator().manual_seed(1)
    m, v = (tree_map(lambda p: torch.randn(p.shape, generator=g), params) for _ in range(2))
    step = torch.tensor(3, dtype=torch.int32)
    return {"params": params, "opt": {"m": m, "v": v, "step": step}, "step": step.clone()}


def test_reshard_2x4_to_1x4_to_3x1_is_bitwise():
    state = _state()
    lay = layout_for(state, Mesh(("data", "model"), (2, 4)))
    s8 = shard_tree(state, lay)
    s4, lay4 = reshard(s8, lay, shrink_mesh(4, model_axis=4))
    assert lay4.mesh.shape == {"data": 1, "model": 4}
    s3, lay3 = reshard(s4, lay4, shrink_mesh(3, model_axis=4))
    assert lay3.mesh.shape == {"data": 3, "model": 1}
    for lay_x, s_x in ((lay4, s4), (lay3, s3)):
        for a, b in zip(tree_leaves(state), tree_leaves(unshard_tree(s_x, lay_x))):
            assert torch.equal(a, b)
    # ElasticState.migrate: the same move through the tracked layout
    es = ElasticState(lay)
    s4b, mesh = es.migrate(s8, range(4), model_axis=4)
    assert mesh.shape == {"data": 1, "model": 4} and es.mesh == mesh
    for a, b in zip(tree_leaves(s4), tree_leaves(s4b)):
        assert torch.equal(a, b)


def test_checkpoint_restores_across_meshes(tmp_path):
    """Saved on the virtual (2, 4) mesh (full arrays, bf16 included),
    restored onto (4, 2) and onto rank 3 of (4, 1), every block bitwise
    (a gloo group's save, one file of blocks a rank, restores in the CLI's
    ``ckpt_mesh``)."""
    from repro_torch.checkpoint.manager import CheckpointManager

    state = _state()
    state["params"]["embed"]["table"] = state["params"]["embed"]["table"].to(torch.bfloat16)
    lay_a = layout_for(state, Mesh(("data", "model"), (2, 4)))
    mgr = CheckpointManager(str(tmp_path / "a"), keep=1)
    mgr.save(1, shard_tree(state, lay_a), layout=lay_a)
    lay_b = lay_a.with_mesh(Mesh(("data", "model"), (4, 2)))
    template = shard_tree(state, lay_b)
    for x in tree_leaves(template):
        x.zero_()
    got = mgr.restore(1, template, layout=lay_b)
    for a, b in zip(tree_leaves(state), tree_leaves(unshard_tree(got, lay_b))):
        assert torch.equal(a, b)
    lay_c = lay_a.with_mesh(Mesh(("data", "model"), (4, 1)), rank=3)
    template = shard_tree(state, lay_c)
    for x in tree_leaves(template):
        x.zero_()
    got = mgr.restore(1, template, layout=lay_c)
    for a, b in zip(tree_leaves(got), tree_leaves(shard_tree(state, lay_c))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("args", [[], ["--virtual", "--device", "cpu"]],
                         ids=["gloo8", "virtual"])
def test_distributed_check_cli(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.testing.distributed_check", *args],
                         capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines == ["PASS compressed psum (int8 + error feedback, 8-way)",
                     "PASS elastic reshard (8 -> 4 -> 3 devices)",
                     "PASS checkpoint restore across meshes (2x4 -> 4x2)",
                     "ALL CHECKS PASSED"], out.stdout


def test_train_distributed_ft_port():
    """``examples/train_distributed_ft.py``'s run on the virtual (data 2,
    model 4) mesh, its sizes kept: 25 steps, checkpoints every 10, a
    failure at step 17 and one restart; the loss falls."""
    from repro_torch.testing.distributed_check import train_distributed_ft

    state, hist, restarts = train_distributed_ft("cpu", log=lambda *a: None)
    assert int(state["step"]) == 25 and restarts == 1
    assert hist[-1] < hist[0]

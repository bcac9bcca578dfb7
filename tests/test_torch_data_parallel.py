"""Data parallelism with FSDP storage (``repro_torch.sharding``, the
``Trainer`` over a (data, SP) mesh) against the JAX ``Trainer`` at
``mesh=None`` on the same global batch: each step's loss and the gathered
parameters after three steps, in float32 at ``MODEL_TOL``.

* the virtual meshes (data 2, model 2), (2, 4) and pods 2 x data 2 x model
  2 (the multi-pod hybrid), reduced qwen3 through TokenRing;
* a gloo group of data 2 x model 2 (one spawn of ``_dp_pg_worker.py``):
  reduced qwen3 at the default clip norm and at one small enough that
  every step clips (the global norm counts each replicated leaf, the
  norms of spec ``(None,)``, once, so the clip scale equals the JAX one),
  reduced qwen3-moe at capacity factor E / K (the router statistics
  averaged over the group's data view as well as the ring), all at remat
  ``"none"``, and reduced qwen3 and falcon-mamba at remat ``"full"`` (each
  layer gathered again when the backward recomputes it, its reduce-scatter
  run from the backward); each dense rank's data-axis bytes equal to
  ``fsdp_comm_bytes``;
* reduced qwen3-moe on the virtual (2, 2) mesh with expert parallelism, at
  capacity factor E / K, where nothing drops (ROADMAP queue 3 item 8);
* the ledger's ``"data"`` class equals ``fsdp_comm_bytes`` a step (the
  per-layer gather's: ``test_torch_layer_gather.py``);
* reduced pixtral-12b on gloo groups of data 1 x model 2 and data 2 x
  model 2 (one spawn of ``_dp_pg_worker.run_vlm`` a group): the loss and
  every gradient of one step, on a batch whose positions are contiguous and
  on one whose positions are zigzag, against JAX ``value_and_grad`` at
  ``mesh=None`` on the same batch (each rank holds the whole image and text
  and embeds its own shard of the sequence).
"""

import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.data import synthetic as jsyn
from repro.data.synthetic import apply_layout
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.runtime import trainer as jtrainer
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.data import synthetic as tsyn
from repro_torch.launch.mesh import data_mesh
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import trainer as ttrainer
from repro_torch.sharding import fsdp_comm_bytes, layout_for, spec_leaves

# Whole-model losses and parameters after AdamW: float32, a few layers,
# reductions in another order (test_torch_training.py's limits).
MODEL_TOL = dict(atol=2e-5, rtol=2e-4)
SPAWN_TIMEOUT_S = 90
STEPS = 3
REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
               vocab_size=97, logits_chunk=16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data_cfg(P, B=4, S=64, vocab=97, layout="zigzag"):
    return dict(vocab_size=vocab, seq_len=S, global_batch=B, seed=0, layout=layout,
                sp_degree=P)


def _jax_init(arch, over, clip=1.0):
    """The JAX Trainer at mesh=None and its initial state."""
    jb = jbuild(JARCHS[arch].reduced(**over), JPctx(mesh=None, impl="xla"))
    jt = jtrainer.Trainer(jb, jtrainer.TrainerConfig(
        lr=1e-3, warmup_steps=1, total_steps=STEPS, opt=jadamw.AdamWConfig(clip_norm=clip)))
    return jt, jt.init_state(jax.random.PRNGKey(1))


def _jax_run(arch, over, data_cfg, clip=1.0):
    """The JAX Trainer at mesh=None: (initial params as numpy, per-step
    metrics, final params)."""
    jt, js = _jax_init(arch, over, clip)
    p0 = jax.tree.map(np.asarray, js["params"])
    data = jsyn.SyntheticDataset(jsyn.SyntheticConfig(**data_cfg))
    metrics = []
    for _ in range(STEPS):
        js, m = jt._jit_step(js, next(data))
        metrics.append({k: float(v) for k, v in m.items()})
    return p0, metrics, jax.tree.map(np.asarray, js["params"])


def _pairs(tparams, jparams):
    """(name, port leaf, JAX leaf) in the port's leaf order; the JAX tree
    stacks the layers."""
    out = []

    def walk(t, j, name, layer=None):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], j[k], f"{name}.{k}", layer)
        elif isinstance(t, list):
            for i, sub in enumerate(t):
                walk(sub, j, f"{name}[{i}]", i)
        else:
            out.append((name, t, np.asarray(j) if layer is None else np.asarray(j)[layer]))

    walk(tparams, jparams, "params")
    return out


def _port_run(arch, over, data_cfg, p0, **pctx_kw):
    cfg = TARCHS[arch].reduced(**over)
    pctx = TPctx(device="cpu", impl="torch", **pctx_kw)
    trainer = ttrainer.Trainer(tbuild(cfg, pctx), ttrainer.TrainerConfig(
        lr=1e-3, warmup_steps=1, total_steps=STEPS))
    state = trainer.state_from_params(from_jax_params(cfg, p0, device="cpu", training=True))
    pctx.storage.ledger.reset()
    state, hist = trainer.run(state, tsyn.SyntheticDataset(tsyn.SyntheticConfig(**data_cfg)),
                              steps=STEPS, log=lambda *a: None)
    return trainer, state, hist


def _check(trainer, state, hist, jmetrics, jfinal):
    np.testing.assert_allclose(hist, [m["loss"] for m in jmetrics], **MODEL_TOL)
    full = trainer.full_params(state)
    for name, a, b in _pairs(full, jfinal):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **MODEL_TOL)
    # each leaf gathered once (remat "none") and reduce-scattered +
    # all-reduced once a step
    want = fsdp_comm_bytes(trainer.params_layout, trainer.bundle.cfg.remat)
    got = trainer.comm.ledger.class_bytes["data"]
    for way in ("fwd", "bwd"):
        assert got[way] == pytest.approx(STEPS * want[way], rel=1e-12)


MESHES = {"2x2": dict(data_degree=2, sp_degree=2),
          "2x4": dict(data_degree=2, sp_degree=4),
          "pods2x2x2": dict(data_degree=2, sp_degree=4, pods=2)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_trainer_on_the_virtual_mesh_matches_jax(mesh):
    kw = MESHES[mesh]
    dc = _data_cfg(kw["sp_degree"])
    p0, jm, jfinal = _jax_run("qwen3-1.7b", REDUCED, dc)
    trainer, state, hist = _port_run("qwen3-1.7b", REDUCED, dc, p0, **kw)
    assert trainer.layout.mesh.shape["data"] == 2
    _check(trainer, state, hist, jm, jfinal)


def test_trainer_on_the_virtual_mesh_moe_with_expert_parallelism():
    """qwen3-moe (8 experts top-2) on the virtual (2, 2) mesh, experts over
    the ring, capacity factor E / K = 4: the router statistics averaged
    over the ring and the data groups."""
    over = dict(capacity_factor=4.0)
    dc = _data_cfg(2, vocab=JARCHS["qwen3-moe-30b-a3b"].reduced().vocab_size)
    p0, jm, jfinal = _jax_run("qwen3-moe-30b-a3b", over, dc)
    trainer, state, hist = _port_run("qwen3-moe-30b-a3b", over, dc, p0, data_degree=2,
                                     sp_degree=2)
    assert trainer.bundle.pctx.ring.data_groups == 2
    _check(trainer, state, hist, jm, jfinal)


def test_trainer_on_a_gloo_group_matches_jax(tmp_path):
    """Four spawned ranks, data 2 x model 2: reduced qwen3 at clip norm 1.0
    and at 0.05 (every step clips); reduced qwen3-moe (8 experts top-2,
    experts over the ring) at capacity factor E / K = 4; reduced qwen3 and
    falcon-mamba (the scan over the ring's contiguous shards) at remat
    "full", every layer gathered inside its remat region."""
    from _dp_pg_worker import run

    moe = "qwen3-moe-30b-a3b"
    moe_over = dict(capacity_factor=4.0)
    cases = [(f"dense{c}", "qwen3-1.7b", REDUCED, c, _data_cfg(2)) for c in (1.0, 0.05)]
    cases.append(("moe", moe, moe_over, 1.0,
                  _data_cfg(2, vocab=JARCHS[moe].reduced(**moe_over).vocab_size)))
    cases.append(("dense_remat", "qwen3-1.7b", dict(REDUCED, remat="full"), 1.0,
                  _data_cfg(2)))
    cases.append(("mamba_remat", "falcon-mamba-7b", dict(n_layers=2, vocab_size=97,
                                                          remat="full"), 1.0,
                  _data_cfg(2, layout="contig")))
    tparams = {}
    for key, arch, over, clip, _ in cases:
        p0 = jax.tree.map(np.asarray, _jax_init(arch, over, clip)[1]["params"])
        tparams[key] = from_jax_params(TARCHS[arch].reduced(**over), p0, device="cpu",
                                       training=True)
        torch.save(tparams[key], tmp_path / f"{key}.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, 4, str(tmp_path / "init"), str(tmp_path),
                                           str(tmp_path / "out.npz"), cases))
             for r in range(4)]
    for p in procs:
        p.start()
    try:  # the JAX oracles while the ranks run
        runs = {key: _jax_run(arch, over, dc, clip=clip) for key, arch, over, clip, dc in cases}
    finally:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    res = np.load(tmp_path / "out.npz")
    for key, arch, over, clip, _ in cases:
        _, jm, jfinal = runs[key]
        cfg = TARCHS[arch].reduced(**over)
        if not cfg.n_experts:  # the router's statistics average over the data view too
            want = fsdp_comm_bytes(layout_for(tparams[key], data_mesh(2, 2)), cfg.remat)
            assert float(res[f"{key}/data_bytes"]) == pytest.approx(STEPS * want["fwd"],
                                                                    rel=1e-12), key
        for i, m in enumerate(jm):
            for k in ("loss", "grad_norm", "clip_scale"):
                np.testing.assert_allclose(res[f"{key}/{k}{i}"], m[k], err_msg=f"{key} {k}{i}",
                                           **MODEL_TOL)
        if clip < 1.0:
            assert all(m["clip_scale"] < 1.0 for m in jm)
        pairs = _pairs(tparams[key], jfinal)
        assert len(pairs) == len(tree_leaves(tparams[key]))
        for j, (name, _, b) in enumerate(pairs):
            np.testing.assert_allclose(res[f"{key}/leaf{j}"], b, err_msg=f"{key} {name}",
                                       **MODEL_TOL)


def test_global_norm_counts_a_replicated_leaf_once():
    """On the virtual mesh every distinct block is present once: the norm
    of the blocks is the norm of the full tree."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.sharding import shard_state

    pctx = TPctx(device="cpu", impl="torch", data_degree=2, sp_degree=2)
    params = tbuild(TARCHS["qwen3-1.7b"].reduced(**REDUCED), pctx).init(0, training=True)
    shards, layout = shard_state(params, pctx.mesh)
    assert any(s == (None,) for s in spec_leaves(layout.specs))  # norms: replicated
    np.testing.assert_allclose(float(global_norm(shards, layout=layout, comm=pctx.storage)),
                               float(global_norm(params)), rtol=1e-6)


def test_plan_divides_the_batch_over_the_data_axis():
    """``plan`` prices one rank's batch, as the reference's does with a data
    axis: the same cost at global batch 8 over 2 data ranks as at 4."""
    from repro_torch.core.api import AttnShapes

    dp = TPctx(device="cpu", data_degree=2, sp_degree=4, strategy="auto")
    sp = TPctx(device="cpu", sp_degree=4, strategy="auto")
    a = dp.plan(AttnShapes(B=8, Sq=4096, Hq=16, Hkv=8, D=128))
    b = sp.plan(AttnShapes(B=4, Sq=4096, Hq=16, Hkv=8, D=128))
    assert a.strategy == b.strategy and a.cost == b.cost
    assert a.compute_flops == b.compute_flops


VLM_MESHES = {"1x2": 1, "2x2": 2}  # the data degree; model 2


def _vlm_batch(layout, B=4, S_text=48, seed=5):
    """Seeded text behind ``frontend_tokens`` patch embeddings; the
    positions cover both, contiguous or in the zigzag order of 2 ranks."""
    cfg = JARCHS["pixtral-12b"].reduced(**REDUCED)
    n_img = cfg.frontend_tokens
    rng = np.random.default_rng(seed)
    S = n_img + S_text
    pos = apply_layout(np.zeros((1, S), np.int32), np.zeros((1, S), np.int32), S, 2,
                       layout)[2]
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S_text)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S_text)).astype(np.int32),
            "positions": np.broadcast_to(pos, (B, S)).copy(),
            "patch_embeds": rng.standard_normal((B, n_img, cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module", params=sorted(VLM_MESHES))
def vlm_group(request, tmp_path_factory):
    """One spawn of ``run_vlm`` on a group of the mesh and the JAX loss and
    gradients on each layout's batch: ``(results, JAX's by layout, port
    parameters)``."""
    from _dp_pg_worker import run_vlm

    data = VLM_MESHES[request.param]
    tmp = tmp_path_factory.mktemp(f"vlm{request.param}")
    jb = jbuild(JARCHS["pixtral-12b"].reduced(**REDUCED), JPctx(mesh=None, impl="xla"))
    jparams = jb.init(jax.random.PRNGKey(3))
    tparams = from_jax_params(TARCHS["pixtral-12b"].reduced(**REDUCED),
                              jax.tree.map(np.asarray, jparams), device="cpu", training=True)
    torch.save(tparams, tmp / "params.pt")
    layouts = ("contig", "zigzag")
    for layout in layouts:
        np.savez(tmp / f"{layout}.npz", **_vlm_batch(layout))
    ctx = mp.get_context("spawn")
    world = 2 * data
    procs = [ctx.Process(target=run_vlm, args=(r, world, str(tmp / "init"), str(tmp),
                                               str(tmp / "out.npz"), data, REDUCED,
                                               [(lay, lay) for lay in layouts]))
             for r in range(world)]
    for p in procs:
        p.start()
    try:  # the JAX oracles while the ranks run
        vg = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))
        jax_runs = {lay: vg(jparams, {k: jnp.asarray(v) for k, v in _vlm_batch(lay).items()})
                    for lay in layouts}
    finally:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return np.load(tmp / "out.npz"), jax_runs, tparams


@pytest.mark.parametrize("layout", ["contig", "zigzag"])
def test_vlm_on_a_gloo_group_matches_jax(vlm_group, layout):
    res, jax_runs, tparams = vlm_group
    (jloss, _), jgrads = jax_runs[layout]
    np.testing.assert_allclose(res[f"{layout}/loss"], float(jloss), **MODEL_TOL)
    pairs = _pairs(tparams, jgrads)
    assert len(pairs) == len(tree_leaves(tparams))
    for j, (name, _, g) in enumerate(pairs):
        np.testing.assert_allclose(res[f"{layout}/leaf{j}"], g, err_msg=f"{layout} {name}",
                                   **MODEL_TOL)

"""The port's hybrid family (``repro_torch.models.rglru``, recurrentgemma-2b)
against the JAX package's ``repro.models.rglru`` on the same numpy inputs,
with the JAX ``init_rg`` parameters carried across (``from_jax_params``).

* the config field by field, and the full config's parameter count equal
  to the JAX tree's;
* ``rg_loss`` and every leaf's gradient at the JAX ``reduced()`` config
  (one superblock and a 1-layer tail, window 64, head dim 32) and at
  ``reduced(d_head=256)`` with remat ``"full"``, at SP 1;
* the same loss and gradients through 4 virtual ranks (the window halo over
  two predecessors, the RG-LRU's scan) and on a gloo group of 4 spawned
  ranks (``_rglru_pg_worker.py``: the conv's halo from the previous rank
  too), against the JAX model at SP 1;
* 80 ``rg_decode_step`` steps, which wrap the 64-slot K/V ring buffer,
  against the JAX decode step (logits and every state leaf) and the port's
  own windowed forward pass;
* the plain flash forward and backward at head dim 256, GQA group 10 and a
  window against the JAX ``flash_attention`` (``impl="xla"`` and
  ``"pallas_interpret"``), and which instance of kernels A, B1 and B2 the
  card would take at D 256; kernel C refuses D 256;
* the bundle: the serving layout's dtypes, the engine's refusal, the
  decode at SP 4 (its ring buffer sequence-sharded) against SP 1, the CLIs.

Float32 throughout.  Model-level limits are ``MODEL_TOL`` of
``test_torch_training.py`` (atol 2e-5, rtol 2e-4); decode logits 1e-4 and
the state 1e-5 (``test_torch_mamba.py``'s); flash out 2e-5 and lse 1e-4
(``test_torch_kernels.py``'s), gradients 1e-4.
"""

import dataclasses
import math
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import _batch

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.kernels import ops as jops
from repro.models import build_model as jbuild
from repro.models import rglru as jrg
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.models import rglru as trg
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving.engine import ServingEngine as TEngine

MODEL_TOL = dict(atol=2e-5, rtol=2e-4)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
NAME = "recurrentgemma-2b"
SPAWN_TIMEOUT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(training=True, sp_degree=1, **over):
    jcfg = JARCHS[NAME].reduced(**over)
    tcfg = TARCHS[NAME].reduced(**over)
    jb = jbuild(jcfg, JPctx(mesh=None))
    jparams = jb.init(jax.random.PRNGKey(3))
    tb = tbuild(tcfg, TPctx(impl="torch", device="cpu", sp_degree=sp_degree,
                            layout=tcfg.layout))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
                              training=training)
    return jb, jparams, tb, tparams


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().numpy()


def _pairs(tree, jtree, name="params"):
    """``(name, port leaf, JAX leaf)`` for every leaf; the JAX tree stacks
    ``supers`` and ``tail`` on a leading dim, the port lists them."""
    out = []

    def walk(t, j, name, index):
        if isinstance(t, dict):
            assert set(t) == set(j), (name, set(t), set(j))
            for key in sorted(t):
                walk(t[key], j[key], f"{name}.{key}", index)
        elif isinstance(t, list):
            for i, sub in enumerate(t):
                walk(sub, j, f"{name}[{i}]", i)
        else:
            out.append((name, t, np.asarray(j) if index is None else np.asarray(j)[index]))

    walk(tree, jtree, name, None)
    return out


def _jax_loss_and_grads(jb, jparams, batch):
    (jloss, _), jgrads = jax.value_and_grad(jb.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jloss), jgrads


def _value_and_grad(tb, tparams, batch):
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tb.loss(tparams, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return float(loss.detach()), jax.tree.map(lambda _: next(it), tparams,
                                              is_leaf=lambda x: isinstance(x, torch.Tensor))


def _check_grads(tgrads, jgrads):
    pairs = _pairs(tgrads, jgrads)
    assert len(pairs) == len(tree_leaves(tgrads))
    for name, a, b in pairs:
        np.testing.assert_allclose(_np(a), b, err_msg=name, **MODEL_TOL)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_config_matches_jax():
    assert dataclasses.asdict(TARCHS[NAME]) == dataclasses.asdict(JARCHS[NAME])
    assert dataclasses.asdict(TARCHS[NAME].reduced()) == dataclasses.asdict(
        JARCHS[NAME].reduced())
    cfg = TARCHS[NAME]
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, cfg.window, cfg.layout) == (
        256, 10, 2048, "contig")
    assert trg.rg_layout(cfg) == (8, 2)


def test_full_config_parameter_count_matches_jax():
    """On the meta device: shapes only, nothing allocated."""
    params = trg.init_rg(TARCHS[NAME], torch.Generator(device="cpu").manual_seed(0),
                         device="meta", training=True)
    n = sum(p.numel() for p in tree_leaves(params))
    specs = jax.eval_shape(lambda k: jrg.init_rg(JARCHS[NAME], k), jax.random.PRNGKey(0))
    assert n == sum(math.prod(x.shape) for x in jax.tree.leaves(specs))
    assert 2.5e9 < n < 3.2e9, n


# ---------------------------------------------------------------------------
# training loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over", [{}, dict(d_head=256, remat="full")],
                         ids=["d32", "d256_remat_full"])
def test_loss_and_gradients_match_jax_sp1(over):
    jb, jparams, tb, tparams = _models(**over)
    batch = _batch(tb.cfg.vocab_size, 2, 128, seed=1)
    jloss, jgrads = _jax_loss_and_grads(jb, jparams, batch)
    tloss, tgrads = _value_and_grad(tb, tparams, batch)
    np.testing.assert_allclose(tloss, jloss, **MODEL_TOL)
    _check_grads(tgrads, jgrads)


def test_loss_and_gradients_over_4_virtual_ranks_match_jax_sp1():
    """128 tokens over 4 virtual ranks, 32 a rank: the window of 64 takes a
    halo of two predecessor shards; the RG-LRU runs on the scan.  Against
    the JAX model at SP 1."""
    jb, jparams, _, _ = _models()
    _, _, tb, tparams = _models(sp_degree=4)
    batch = _batch(tb.cfg.vocab_size, 2, 128, seed=2)
    jloss, jgrads = _jax_loss_and_grads(jb, jparams, batch)
    tloss, tgrads = _value_and_grad(tb, tparams, batch)
    np.testing.assert_allclose(tloss, jloss, **MODEL_TOL)
    _check_grads(tgrads, jgrads)
    assert tb.pctx.ring.link_bytes["fwd"] > 0 and tb.pctx.ring.link_bytes["bwd"] > 0


def test_process_group_matches_jax(tmp_path):
    """A gloo group of 4 spawned ranks, each holding its contiguous shard of
    128 tokens: the conv's halo from the previous rank, the window halo and
    the scan.  The ranks' token-weighted loss and summed gradients against
    the JAX model at SP 1."""
    from _rglru_pg_worker import run

    P = 4
    jb, jparams, tb, tparams = _models()
    batch = _batch(tb.cfg.vocab_size, 2, 128, seed=4)
    np.savez(tmp_path / "batch.npz", **batch)
    torch.save(tparams, tmp_path / "params.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, P, str(tmp_path / "init"), str(tmp_path),
                                           str(tmp_path / f"rank{r}.npz")))
             for r in range(P)]
    for p in procs:
        p.start()
    try:
        jloss, jgrads = _jax_loss_and_grads(jb, jparams, batch)  # while the ranks run
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(P)]
    denom = sum(float(r["denom"]) for r in ranks)
    loss = sum(float(r["loss"]) * float(r["denom"]) for r in ranks) / denom
    np.testing.assert_allclose(loss, jloss, **MODEL_TOL)
    pairs = _pairs(tparams, jgrads)
    assert len(pairs) == sum(1 for k in ranks[0].files if k.startswith("grad/"))
    for name, _, jg in pairs:
        g = sum(r["grad/" + name] for r in ranks) / denom
        np.testing.assert_allclose(g, jg, err_msg=name, **MODEL_TOL)
    assert all(float(r["halo_bytes"]) > 0 for r in ranks)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def test_decode_wraps_the_ring_buffer_and_matches_jax_and_the_forward():
    """80 tokens fed one a step through ``rg_decode_step``: past step 64 the
    K/V ring buffer of ``window`` = 64 slots wraps.  Every step's logits
    against the JAX decode step, the final state leaf by leaf, and the logits
    at every position against the port's windowed forward pass plus the
    tied head."""
    jb, jparams, tb, tparams = _models(training=False)
    cfg = tb.cfg
    B, S = 2, 80
    assert S > cfg.window
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jstate = jb.init_serve_state(B, S)
    tstate = tb.init_serve_state(B, S, "cpu")
    assert tstate["k"].shape[2] == cfg.window
    step = jax.jit(jb.decode_step)
    rows = []
    for t in range(S):
        jl, jstate = step(jparams, jnp.asarray(tokens[:, t]), jstate)
        tl, tstate = tb.decode_step(tparams, _t(tokens[:, t]), tstate)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {t}", **LOGIT_TOL)
        rows.append(tl)
    assert set(tstate) == set(jstate)
    for key in tstate:
        np.testing.assert_allclose(_np(tstate[key]), np.asarray(jstate[key], np.float32),
                                   err_msg=key, **STATE_TOL)
    assert (tstate["pos"].numpy() == np.arange(S - cfg.window, S)[(np.arange(cfg.window)
                                                                    - S) % cfg.window]).all()
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    with torch.no_grad():
        x = trg.rg_apply(tparams, _t(tokens), _t(positions), cfg=cfg, pctx=tb.pctx)
        fwd = x @ tparams["embed"]["table"].T
    np.testing.assert_allclose(torch.stack(rows, 1).numpy(), fwd.numpy(), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# kernels at head dim 256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
def test_plain_flash_d256_group10_window_matches_jax(impl):
    """recurrentgemma's attention call (10/1 heads, D 256, causal, window)
    at a small length: the plain forward and its backward (with a nonzero
    lse cotangent) against the JAX flash."""
    B, S, Hq, Hkv, D, W = 1, 64, 10, 1, 256, 24
    rng = np.random.default_rng(23)
    q, dout = (rng.standard_normal((B, S, Hq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    dlse = rng.standard_normal((B, S, Hq)).astype(np.float32)
    kw = dict(causal=True, window=W, block_q=32, block_k=32)

    def jfn(q, k, v):
        return jops.flash_attention(q, k, v, impl=impl, **kw)

    (jout, jlse), vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out, lse = tops.flash_attention(tq, tk, tv, impl="torch", **kw)
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse), atol=1e-4, rtol=1e-4)
    grads = torch.autograd.grad((out, lse), (tq, tk, tv), (_t(dout), _t(dlse)))
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(_np(g), np.asarray(jg), err_msg=name, atol=1e-4, rtol=1e-4)


def test_d256_instances_and_refusals():
    """At D 256 kernel A's bf16 Sq > 4 calls run on its wgmma instance
    (split by O's columns), its float32 ones on the CUDA-core instance, and Sq <= 4
    on the decode core, whose D-256 instances take 1 to 16 rows a KV head;
    B1 and B2 run bf16 on their column-split wgmma instances and float32 on
    the CUDA cores; kernel C takes D 256 and refuses CPU tensors, as at any
    head dim."""
    bf, f32 = torch.bfloat16, torch.float32
    assert fa.flash_fwd_instance(bf, 4096, 256) == fa.flash_fwd_instance(bf, 37, 256) == (
        "wgmma")
    assert fa.flash_fwd_instance(f32, 4096, 256) == fa.flash_fwd_instance(f32, 37, 256) == (
        "cuda_core")
    assert fa.flash_fwd_instance(bf, 1, 256) == fa.flash_fwd_instance(f32, 4, 256) == "decode"
    assert fa.flash_bwd_instance(bf, 256) == "wgmma"
    assert fa.flash_bwd_instance(f32, 256) == "cuda_core"
    assert fa.flash_bwd_instance(bf, 128) == "wgmma"
    for group, Sq in ((10, 1), (8, 1), (2, 4), (1, 1), (16, 1)):
        fa.check_decode_rows("A", 256, group, Sq)
    fa.check_decode_rows("A", 128, 32, 2)  # below D 256 every count up to 64 is built
    for group, Sq in ((17, 1), (10, 2)):
        with pytest.raises(ValueError, match="1 to 16 rows"):
            fa.check_decode_rows("A", 256, group, Sq)
    from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda

    q = torch.zeros((1, 1, 10, 256))
    pool = torch.zeros((4, 8, 1, 256))
    i32 = torch.int32
    assert 256 in fa.PAGED_DIMS
    with pytest.raises(ValueError, match="must be on one CUDA device"):
        paged_decode_fwd_cuda(q, pool, pool, torch.zeros((4, 8), dtype=i32),
                              torch.zeros((1, 2), dtype=i32), torch.zeros((1, 1), dtype=i32),
                              window=None, scale=1.0)
    with pytest.raises(ValueError, match="must be on one CUDA device"):
        fa.flash_attention_fwd_cuda(q, pool[:1], pool[:1], torch.zeros((1, 1), dtype=i32),
                                    torch.zeros((1, 8), dtype=i32), causal=True, window=None,
                                    scale=1.0)


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------


def test_serving_layout_and_engine_refusal():
    """Serving stores the dense weights in the compute dtype but the gates,
    which compute in float32, ``lam``, the conv and the norms in
    ``param_dtype``; training keeps every leaf in ``param_dtype``.  The
    recurrent state cannot be rolled back per slot, so the engine refuses
    the bundle with the JAX message."""
    cfg = TARCHS[NAME].reduced(dtype="bfloat16")
    jparams = jrg.init_rg(JARCHS[NAME].reduced(dtype="bfloat16"), jax.random.PRNGKey(0))
    bundle = tbuild(cfg, TPctx(device="cpu"))
    for params in (bundle.init(0), from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                                                   device="cpu")):
        rec = params["supers"][0]["rec1"]
        for key in ("lin_x", "lin_y", "lin_out"):
            assert rec[key]["w"].dtype == torch.bfloat16, key
        assert params["supers"][0]["attn"]["attn"]["wq"]["w"].dtype == torch.bfloat16
        assert params["embed"]["table"].dtype == torch.bfloat16
        for key in ("gate_a", "gate_i"):
            assert rec[key]["w"].dtype == torch.float32, key
        for t in (rec["lam"], rec["conv_w"], rec["conv_b"], rec["norm"]["scale"]):
            assert t.dtype == torch.float32
    for t in tree_leaves(bundle.init(0, training=True)):
        assert t.dtype == torch.float32
    jb, _, tb, tparams = _models(training=False)
    assert tb.decode_rollback_safe is jb.decode_rollback_safe is False
    assert tb.prefill_chunk is tb.prefill is tb.decode_step_paged is None
    with pytest.raises(NotImplementedError, match="rolled back"):
        TEngine(tb, tparams, max_batch=2, max_len=32, device="cpu")
    # at SP 4 the ring buffer is sequence-sharded over the ring (rank-major
    # on the virtual ring): the same logits as at SP 1
    _, _, tb4, _ = _models(training=False, sp_degree=4)
    s1, s4 = tb.init_serve_state(2, 32, "cpu"), tb4.init_serve_state(2, 32, "cpu")
    assert s4["k"].shape[1:3] == (4 * 2, tb.cfg.window // 4)
    assert s4["pos"].shape == (4 * 2, tb.cfg.window // 4)
    for t in range(3):
        tok = torch.full((2,), 5 + t, dtype=torch.int32)
        l1, _ = tb.decode_step(tparams, tok, s1)
        l4, _ = tb4.decode_step(tparams, tok, s4)
        np.testing.assert_allclose(l4.numpy(), l1.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("sp", [1, 4])
def test_train_cli(capsys, sp):
    from repro_torch.launch.train import main as train

    hist = train(["--arch", NAME, "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                  "--seq", "128", "--sp-degree", str(sp)])
    assert len(hist) == 2 and all(np.isfinite(hist))
    out = capsys.readouterr().out
    assert "final step 2" in out
    if sp > 1:
        assert "the window halo and the scan over 4 virtual ranks" in out


def test_serve_cli_refuses():
    from repro_torch.launch.serve import main as serve

    with pytest.raises(NotImplementedError, match="rolled back"):
        serve(["--arch", NAME, "--reduced", "--device", "cpu", "--requests", "2"])

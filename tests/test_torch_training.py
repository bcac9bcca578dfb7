"""The port's training slice against the JAX package, on the same numpy
inputs: the flash backward (plain version, through the autograd Function),
the tile counts, the chunked cross entropy, ``lm_loss`` and its gradients,
AdamW, the Trainer, the synthetic data and the train CLI.

The backward kernels B1/B2 need the card: ``chip_smoke.py`` holds them
against :func:`flash_attention_bwd_torch` there.  Everything here runs in
float32 on the CPU; each tolerance is stated where it is used.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core import zigzag as jzz
from repro.core.api import ParallelContext as JPctx
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro.runtime import trainer as jtrainer
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core import zigzag as tzz
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import PAD_POS
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import trainer as ttrainer

# The plain backward is the same blockwise algorithm as the JAX one, in
# float32, with sums taken in another order: 2e-5 holds every case.
BWD_TOL = dict(atol=2e-5, rtol=2e-5)
# Whole-model losses and gradients: float32, a few layers, reductions over
# the vocabulary and the sequence in another order.
MODEL_TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """These steps are tiny: one intra-op thread each keeps them fast when
    the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# flash backward (tests/test_kernels.py::BWD_CASES)
# ---------------------------------------------------------------------------

BWD_CASES = [
    # id, (B, S, Hq, Hkv, D), causal, layout, window
    ("causal", (1, 128, 2, 2, 32), True, "contig", None),
    ("noncausal", (1, 128, 2, 2, 32), False, "contig", None),
    ("gqa", (2, 128, 4, 2, 32), True, "contig", None),
    ("mqa", (1, 128, 4, 1, 64), True, "contig", None),
    ("zigzag", (1, 256, 2, 2, 32), True, "zigzag", None),
    ("zigzag_gqa", (1, 256, 4, 2, 32), True, "zigzag", None),
    ("window", (1, 256, 2, 2, 32), True, "contig", 64),
]
BWD_TILES = dict(block_q=64, block_k=64, block_q_bwd=32, block_k_bwd=32)


def _bwd_data(case_id, shape, layout):
    B, S, Hq, Hkv, D = shape
    rng = _rng("bwd", case_id, shape)
    q, w = (rng.standard_normal((B, S, Hq, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    wl = rng.standard_normal((B, S, Hq)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    if layout == "zigzag":
        pos = np.concatenate([tzz.zigzag_positions(S, 4, j).numpy() for j in range(4)])
    return q, k, v, w, wl, np.broadcast_to(pos, (B, S)).copy()


def _flash_grads(q, k, v, w, wl, q_pos, k_pos, *, jax_impl="xla", **kw):
    """Gradients of ``sum(out*w) + sum(lse*wl)`` (dead lse taken as 0) by the
    port's Function (plain impl) and by ``jax.grad`` of the JAX flash."""
    def jloss(q, k, v):
        out, lse = jops.flash_attention(q, k, v, q_pos=jnp.asarray(q_pos),
                                        k_pos=jnp.asarray(k_pos), impl=jax_impl, **kw)
        lse = jnp.where(jnp.isneginf(lse), 0.0, lse)
        return jnp.sum(out * w) + jnp.sum(lse * wl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_(True) for x in (q, k, v))
    out, lse = tops.flash_attention(tq, tk, tv, q_pos=_t(q_pos), k_pos=_t(k_pos), impl="torch",
                                    **kw)
    lse = torch.where(torch.isneginf(lse), 0.0, lse)
    loss = (out * _t(w)).sum() + (lse * _t(wl)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    return got, want


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_backward_plain_matches_jax(case):
    case_id, shape, causal, layout, window = case
    q, k, v, w, wl, pos = _bwd_data(case_id, shape, layout)
    got, want = _flash_grads(q, k, v, w, wl, pos, pos, causal=causal, window=window,
                             **BWD_TILES)
    for g, x, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(_np(g), np.asarray(x), err_msg=f"d{name}", **BWD_TOL)


def test_flash_backward_plain_matches_pallas_interpret():
    """One case against the Pallas backward kernels themselves."""
    case_id, shape, causal, layout, window = BWD_CASES[5]
    q, k, v, w, wl, pos = _bwd_data(case_id, shape, layout)
    got, want = _flash_grads(q, k, v, w, wl, pos, pos, jax_impl="pallas_interpret",
                             causal=causal, window=window, **BWD_TILES)
    for g, x, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(_np(g), np.asarray(x), err_msg=f"d{name}", **BWD_TOL)


def test_flash_backward_dead_rows_are_zero():
    """Rows that see no key (lse = -inf): finite gradients, exactly 0 where
    nothing is seen, and the rest as JAX computes it.  Row 0's first 16
    queries precede every key; batch row 1's keys are all padding."""
    B, S, H, D = 2, 64, 2, 32
    rng = _rng("dead")
    q, k, v, w = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4))
    wl = rng.standard_normal((B, S, H)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    k_pos = q_pos.copy()
    q_pos[0, :16] = -1
    k_pos[1] = PAD_POS
    (dq, dk, dv), want = _flash_grads(q, k, v, w, wl, q_pos, k_pos, causal=True, block_q=32,
                                      block_k=32)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    for dead in (dq[1], dk[1], dv[1], dq[0, :16]):
        assert torch.equal(dead, torch.zeros_like(dead))
    for g, x in zip((dq, dk, dv), want):
        np.testing.assert_allclose(_np(g), np.asarray(x), **BWD_TOL)


def test_flash_backward_takes_unused_lse_as_zero():
    """Only ``out`` used: the Function gets ``dlse = None`` and treats it as 0."""
    q, k, v, w, wl, pos = _bwd_data("causal", (1, 128, 2, 2, 32), "contig")
    got, want = _flash_grads(q, k, v, w, np.zeros_like(wl), pos, pos, causal=True,
                             block_q=32, block_k=32)
    tq = _t(q).requires_grad_(True)
    out, _ = tops.flash_attention(tq, _t(k), _t(v), causal=True, impl="torch", block_q=32,
                                  block_k=32)
    (dq,) = torch.autograd.grad((out * _t(w)).sum(), (tq,))
    np.testing.assert_allclose(_np(dq), _np(got[0]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(dq), np.asarray(want[0]), **BWD_TOL)


@pytest.mark.parametrize("layout,window", [("contig", None), ("zigzag", None),
                                           ("contig", 48), ("pad", None)])
def test_backward_tile_counts_match_jax(layout, window):
    B, S = 2, 256
    pos = np.arange(S, dtype=np.int32)
    if layout == "zigzag":
        pos = np.concatenate([np.asarray(jzz.zigzag_positions(S, 4, j)) for j in range(4)])
    q_pos = np.broadcast_to(pos, (B, S)).copy()
    k_pos = q_pos.copy()
    if layout == "pad":
        k_pos[1, 100:] = PAD_POS
    for causal in (False, True):
        for bq, bk in ((32, 32), (64, 16), (512, 512)):
            got = tops.backward_tile_counts(_t(q_pos), _t(k_pos), block_q=bq, block_k=bk,
                                            causal=causal, window=window)
            want = jops.backward_tile_counts(jnp.asarray(q_pos), jnp.asarray(k_pos),
                                             block_q=bq, block_k=bk, causal=causal,
                                             window=window)
            assert got == want
            bq_, bk_ = tops.pick_block(S, bq), tops.pick_block(S, bk)
            np.testing.assert_array_equal(
                tops._tile_skip_grid(_t(q_pos), _t(k_pos), bq_, bk_, causal=causal,
                                     window=window).numpy(),
                np.asarray(jops._tile_skip_grid(jnp.asarray(q_pos), jnp.asarray(k_pos), bq_,
                                                bk_, causal=causal, window=window)))


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------


def test_chunked_cross_entropy_matches_jax():
    B, S, d, V = 2, 48, 16, 37
    rng = _rng("ce")
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)

    def jce(x, w):
        return jlayers.chunked_cross_entropy(x, w, jnp.asarray(labels), mask=jnp.asarray(mask),
                                             chunk=16, compute_dtype=jnp.float32)

    (jloss, jden), jgrads = jax.value_and_grad(jce, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    loss, den = tlayers.chunked_cross_entropy(tx, tw, _t(labels), mask=_t(mask), chunk=16,
                                              compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, (tx, tw))
    assert float(den) == float(jden)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-6, rtol=1e-6)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(_np(g), np.asarray(jg), atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# lm_loss and its gradients on a reduced qwen3-1.7b
# ---------------------------------------------------------------------------

REDUCED = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
               vocab_size=97, logits_chunk=16)
VARIANTS = {
    "mha_tied": REDUCED,
    "gqa_tied": dict(REDUCED, n_heads=4, n_kv_heads=2),
    "mha_untied": dict(REDUCED, tie_embeddings=False),
    "gqa_untied": dict(REDUCED, n_heads=4, n_kv_heads=1, tie_embeddings=False),
}


def _models(over, **pctx):
    jcfg = JARCHS["qwen3-1.7b"].reduced(**over)
    tcfg = TARCHS["qwen3-1.7b"].reduced(**over)
    assert tcfg == type(tcfg)(**{f: getattr(jcfg, f) for f in tcfg.__dataclass_fields__})
    jb = jbuild(jcfg, JPctx(mesh=None, impl="xla"))
    tb = tbuild(tcfg, TPctx(impl="torch", device="cpu", **pctx))
    return jb, tb


def _batch(vocab, B, S, seed=0, layout="contig", sp_degree=1):
    return next(jsyn.SyntheticDataset(jsyn.SyntheticConfig(
        vocab_size=vocab, seq_len=S, global_batch=B, seed=seed, layout=layout,
        sp_degree=sp_degree)))


def _grad_pairs(tgrads, jgrads, n_layers):
    """(name, port leaf, JAX leaf) for every parameter; the JAX tree stacks
    the layers on a leading dim."""
    flat = []

    def walk(t, j, name, layer=None):
        if isinstance(t, dict):
            assert set(t) == set(j), (name, set(t), set(j))
            for key in t:
                walk(t[key], j[key], f"{name}.{key}", layer)
        else:
            flat.append((name, t, np.asarray(j) if layer is None else np.asarray(j)[layer]))

    for key in tgrads:
        if key == "layers":
            for l in range(n_layers):
                walk(tgrads["layers"][l], jgrads["layers"], f"layers[{l}]", l)
        else:
            walk(tgrads[key], jgrads[key], key)
    return flat


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lm_loss_and_gradients_match_jax(variant):
    from repro_torch.launch.train_step import value_and_grad

    jb, tb = _models(VARIANTS[variant])
    jparams = jb.init(jax.random.PRNGKey(0))
    batch = _batch(97, 2, 64, layout="zigzag", sp_degree=2)
    (jloss, jm), jgrads = jax.value_and_grad(jb.loss, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = from_jax_params(tb.cfg, jax.tree.map(np.asarray, jparams), device="cpu",
                              training=True)
    assert all(p.dtype == torch.float32 for p in tadamw.tree_leaves(tparams))
    (loss, m), grads = value_and_grad(tb.loss, tparams, ttrainer.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    assert float(m["tokens"]) == float(jm["tokens"])
    pairs = _grad_pairs(grads, jgrads, tb.cfg.n_layers)
    assert len(pairs) == len(jax.tree.leaves(jgrads)) + (tb.cfg.n_layers - 1) * len(
        jax.tree.leaves(jgrads["layers"]))
    for name, g, jg in pairs:
        np.testing.assert_allclose(_np(g), jg, err_msg=name, **MODEL_TOL)


def test_remat_full_and_none_give_the_same_gradients():
    from repro_torch.launch.train_step import value_and_grad

    over = VARIANTS["gqa_tied"]
    _, tb = _models(over)
    params = tb.init(3, training=True)
    batch = ttrainer.batch_to_device(_batch(97, 2, 64, seed=1), "cpu")
    results = {}
    for remat in ("full", "none"):
        _, tb_r = _models(dict(over, remat=remat))
        results[remat] = value_and_grad(tb_r.loss, params, batch)
    (lf, _), gf = results["full"]
    (ln, _), gn = results["none"]
    # the recompute repeats the same float32 ops on the same inputs
    assert torch.equal(lf, ln)
    for a, b in zip(tadamw.tree_leaves(gf), tadamw.tree_leaves(gn)):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    _, tb_dots = _models(dict(over, remat="dots"))
    with pytest.raises(NotImplementedError, match="dots"):
        tb_dots.loss(params, batch)


def test_training_storage_keeps_param_dtype():
    over = dict(REDUCED, dtype="bfloat16")
    _, tb = _models(over)
    train = tb.init(0, training=True)
    serve = tb.init(0)
    assert {p.dtype for p in tadamw.tree_leaves(train)} == {torch.float32}
    assert serve["embed"]["table"].dtype == torch.bfloat16
    assert serve["final_norm"]["scale"].dtype == torch.float32
    # the serving layout is the training one cast once
    torch.testing.assert_close(serve["layers"][1]["mlp"]["up"]["w"],
                               train["layers"][1]["mlp"]["up"]["w"].to(torch.bfloat16),
                               atol=0, rtol=0)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_and_cosine_lr_match_jax():
    rng = _rng("adamw")
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda s: (rng.standard_normal(s) * 3).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple)) for _ in range(3)]
    ocfg = dict(clip_norm=0.5)  # every step's gradient norm is above it: the clip is active
    jp, js = jax.tree.map(jnp.asarray, params), jadamw.adamw_init(params)
    tp = jax.tree.map(_t, params)
    ts = tadamw.adamw_init(tp)
    tcfg = jtrainer.TrainerConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    pcfg = ttrainer.TrainerConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    for step, g in enumerate(grads, start=1):
        jlr = jtrainer.cosine_lr(tcfg, jnp.int32(step))
        tlr = ttrainer.cosine_lr(pcfg, torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-6)
        jp, js, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), js, jp, lr=jlr,
                                         cfg=jadamw.AdamWConfig(**ocfg))
        tp, ts, tm = tadamw.adamw_update(jax.tree.map(_t, g), ts, tp, lr=tlr,
                                         cfg=tadamw.AdamWConfig(**ocfg))
        assert float(tm["clip_scale"]) < 1.0
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == step
        for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            for a, b in zip(tadamw.tree_leaves(tree_t), jax.tree.leaves(tree_j)):
                np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6, rtol=1e-5)
    for step in (0, 1, 2, 4, 6, 9):
        np.testing.assert_allclose(
            float(ttrainer.cosine_lr(pcfg, torch.tensor(step, dtype=torch.int32))),
            float(jtrainer.cosine_lr(tcfg, jnp.int32(step))), rtol=1e-6, atol=1e-12)


def test_make_train_step_matches_jax():
    from repro.launch.train_step import make_train_step as jmake
    from repro_torch.launch.train_step import make_train_step as tmake

    jb, tb = _models(VARIANTS["gqa_tied"])
    jparams = jb.init(jax.random.PRNGKey(2))
    tparams = from_jax_params(tb.cfg, jax.tree.map(np.asarray, jparams), device="cpu",
                              training=True)
    batch = _batch(97, 2, 32, seed=3)
    jp, _, jm = jmake(jb, lr=1e-3)(jparams, jadamw.adamw_init(jparams),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    tp, ts, tm = tmake(tb, lr=1e-3)(tparams, tadamw.adamw_init(tparams),
                                    ttrainer.batch_to_device(batch, "cpu"))
    assert int(ts["step"]) == 1
    for key in ("loss", "ce_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), err_msg=key, **MODEL_TOL)
    for name, a, b in _grad_pairs(tp, jp, tb.cfg.n_layers):
        np.testing.assert_allclose(_np(a), b, err_msg=name, **MODEL_TOL)


# ---------------------------------------------------------------------------
# Trainer (tests/test_substrate.py's tiny bundle)
# ---------------------------------------------------------------------------

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
            vocab_size=97)
DATA = dict(vocab_size=97, seq_len=32, global_batch=8, seed=0)


def _run_port(tb, params, tcfg, steps):
    tr = ttrainer.Trainer(tb, tcfg)
    state = tr.state_from_params(params)
    return tr.run(state, tsyn.SyntheticDataset(tsyn.SyntheticConfig(**DATA)), steps=steps,
                  log=lambda *a: None)


def test_trainer_matches_jax_trainer():
    jb, tb = _models(TINY)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jt = jtrainer.Trainer(jb, jtrainer.TrainerConfig(**kw))
    js = jt.init_state(jax.random.PRNGKey(1))
    tparams = from_jax_params(tb.cfg, jax.tree.map(np.asarray, js["params"]), device="cpu",
                              training=True)
    js, jhist = jt.run(js, jsyn.SyntheticDataset(jsyn.SyntheticConfig(**DATA)), steps=3,
                       log=lambda *a: None)
    ts, thist = _run_port(tb, tparams, ttrainer.TrainerConfig(**kw), 3)
    np.testing.assert_allclose(thist, jhist, **MODEL_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    for name, a, b in _grad_pairs(ts["params"], js["params"], tb.cfg.n_layers):
        np.testing.assert_allclose(_np(a), b, err_msg=name, **MODEL_TOL)


def test_trainer_microbatch_accumulation_matches():
    _, tb = _models(TINY)
    params = tb.init(1, training=True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    s1, _ = _run_port(tb, tadamw.tree_map(torch.clone, params), ttrainer.TrainerConfig(**kw), 3)
    s2, _ = _run_port(tb, tadamw.tree_map(torch.clone, params),
                      ttrainer.TrainerConfig(microbatches=4, **kw), 3)
    for a, b in zip(tadamw.tree_leaves(s1["params"]), tadamw.tree_leaves(s2["params"])):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=2e-4)


def test_trainer_loss_decreases():
    _, tb = _models(TINY)
    tr = ttrainer.Trainer(tb, ttrainer.TrainerConfig(lr=3e-3, warmup_steps=2, total_steps=30))
    state = tr.init_state(0)
    state, hist = tr.run(state, tsyn.SyntheticDataset(tsyn.SyntheticConfig(**DATA)),
                         log=lambda *a: None)
    assert len(hist) == 30 and int(state["step"]) == 30
    assert hist[-1] < hist[0] - 0.2, (hist[0], hist[-1])


def test_trainer_refuses_what_is_not_ported(tmp_path):
    _, tb = _models(TINY)
    with pytest.raises(NotImplementedError, match="checkpoint/manager.py"):
        ttrainer.Trainer(tb, ttrainer.TrainerConfig(checkpoint_dir=str(tmp_path)))
    _, tb_sp = _models(TINY, sp_degree=2)
    params = tb_sp.init(0, training=True)
    with pytest.raises(NotImplementedError, match="ring slice"):
        tb_sp.loss(params, ttrainer.batch_to_device(_batch(97, 2, 32), "cpu"))


# ---------------------------------------------------------------------------
# data and zigzag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout,sp_degree", [("contig", 1), ("zigzag", 4)])
def test_synthetic_batches_identical_to_jax(layout, sp_degree):
    cfg = dict(vocab_size=1000, seq_len=64, global_batch=4, seed=7, layout=layout,
               sp_degree=sp_degree)
    jd = jsyn.SyntheticDataset(jsyn.SyntheticConfig(**cfg), process_index=1, process_count=2)
    td = tsyn.SyntheticDataset(tsyn.SyntheticConfig(**cfg), process_index=1, process_count=2)
    for _ in range(3):
        jb, tb = next(jd), next(td)
        assert set(jb) == set(tb)
        for key in jb:
            assert jb[key].dtype == tb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])
    assert td.state_dict() == jd.state_dict()
    corpus = _rng("corpus").integers(0, 500, 4000).astype(np.int32)
    kw = dict(seq_len=64, global_batch=4, seed=3, layout=layout, sp_degree=sp_degree)
    jp, tp = jsyn.PackedDataset(corpus, **kw), tsyn.PackedDataset(corpus, **kw)
    for _ in range(2):
        for a, b in zip(next(jp).values(), next(tp).values()):
            np.testing.assert_array_equal(b, a)


def test_zigzag_matches_jax():
    S, P = 64, 4
    x = _rng("zz").standard_normal((2, S, 3)).astype(np.float32)
    z = tzz.to_zigzag(_t(x), P)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jzz.to_zigzag(jnp.asarray(x), P)))
    np.testing.assert_array_equal(tzz.from_zigzag(z, P).numpy(), x)
    np.testing.assert_array_equal(tzz.zigzag_device_order(P), jzz.zigzag_device_order(P))
    assert tzz.zigzag_chunk_ids(P) == jzz.zigzag_chunk_ids(P)
    for j in range(P):
        np.testing.assert_array_equal(tzz.zigzag_positions(S, P, j).numpy(),
                                      np.asarray(jzz.zigzag_positions(S, P, j)))
        np.testing.assert_array_equal(tzz.contig_positions(S, P, j).numpy(),
                                      np.asarray(jzz.contig_positions(S, P, j)))
    for a in range(3):
        for b in range(3):
            assert tzz.block_kind(a, b) == jzz.block_kind(a, b)
    with pytest.raises(ValueError, match="divisible by 2P"):
        tzz.to_zigzag(_t(x[:, :60]), P)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def test_train_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch.train import main

    hist = main(["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "64"])
    assert len(hist) == 3 and all(np.isfinite(hist))
    assert "final step 3" in capsys.readouterr().out


def test_train_cli_and_trainer_without_a_card_raise(monkeypatch):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        main(["--reduced", "--steps", "1"])
    bundle = tbuild(TARCHS["qwen3-1.7b"].reduced(**TINY), TPctx())  # device="cuda"
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ttrainer.Trainer(bundle, ttrainer.TrainerConfig())

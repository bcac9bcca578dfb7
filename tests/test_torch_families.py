"""The MoE and VLM families of the port (qwen3-moe-30b-a3b, llama4-scout-
17b-a16e, pixtral-12b, reduced) against the JAX package at model level, on
the same numpy inputs with the JAX ``init_lm`` parameters carried across
(``from_jax_params``): the configs field by field, ``lm_loss`` (CE, aux,
total) and every leaf's gradient (pixtral with ``patch_embeds``), one AdamW
step, remat ``"dots"``, ``lm_prefill`` with and without the image prefix,
the serving steps, the engines, qwen3-moe through TokenRing at SP 4 on the
virtual ring (capacity at which nothing drops) against JAX at SP 1, the
serving layout's dtypes, the CLIs and what ``build_model`` refuses.

Float32 throughout; model-level limits are ``MODEL_TOL`` of
``test_torch_training.py`` (atol 2e-5, rtol 2e-4), serving steps those of
``test_torch_serving.py`` (logits 1e-4, K/V 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_engine import JEngine
from _moe_jax_oracle import flat_leaves
from test_torch_serving import _drive
from test_torch_training import _batch, _grad_pairs

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import trainer as ttrainer
from repro_torch.serving.engine import ServingEngine as TEngine

MODEL_TOL = dict(atol=2e-5, rtol=2e-4)
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
             vocab_size=97, moe_d_ff=32)
MODELS = {"qwen3_moe": "qwen3-moe-30b-a3b", "llama4": "llama4-scout-17b-a16e",
          "pixtral": "pixtral-12b"}
# 8 experts, top 2: a capacity factor of E / K lets an expert take every
# token of a row (and every entry of a rank), so nothing drops
NO_DROP = dict(capacity_factor=4.0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(model, training=False, sp_degree=1, strategy="tokenring", **over):
    name = MODELS[model]
    jcfg = JARCHS[name].reduced(**dict(SMALL, **over))
    tcfg = TARCHS[name].reduced(**dict(SMALL, **over))
    jb = jbuild(jcfg, JPctx(mesh=None, impl="xla"))
    jparams = jb.init(jax.random.PRNGKey(len(name)))
    tb = tbuild(tcfg, TPctx(impl="torch", device="cpu", sp_degree=sp_degree,
                            strategy=strategy))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
                              training=training)
    return jb, jparams, tb, tparams


def _vlm_batch(cfg, B, S_text, seed):
    """A text batch behind ``cfg.frontend_tokens`` seeded patch embeddings;
    positions cover both."""
    batch = _batch(cfg.vocab_size, B, S_text, seed=seed)
    n_img = cfg.frontend_tokens
    rng = np.random.default_rng(seed)
    batch["patch_embeds"] = rng.standard_normal((B, n_img, cfg.d_model)).astype(np.float32)
    batch["positions"] = np.broadcast_to(np.arange(n_img + S_text, dtype=np.int32),
                                         (B, n_img + S_text)).copy()
    return batch


def _loss_batch(model, cfg, seed=0):
    if model == "pixtral":
        return _vlm_batch(cfg, 2, 48, seed)
    return _batch(cfg.vocab_size, 2, 64, seed=seed)


def test_configs_match_jax_field_by_field():
    for name in MODELS.values():
        j, t = JARCHS[name], TARCHS[name]
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
        assert t.reduced() == TArchConfig(**{f: getattr(j.reduced(), f)
                                             for f in t.__dataclass_fields__})


@pytest.mark.parametrize("model", sorted(MODELS))
def test_loss_and_gradients_match_jax(model):
    from repro_torch.launch.train_step import value_and_grad

    jb, jparams, tb, tparams = _models(model, training=True)
    batch = _loss_batch(model, tb.cfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, m), grads = value_and_grad(tb.loss, tparams, ttrainer.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    for key in ("ce_loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), err_msg=key, **MODEL_TOL)
    assert (float(m["aux_loss"]) > 0) == (model != "pixtral")
    pairs = _grad_pairs(grads, jgrads, tb.cfg.n_layers)
    assert len(pairs) == len(jax.tree.leaves(jgrads)) + (tb.cfg.n_layers - 1) * len(
        jax.tree.leaves(jgrads["layers"]))
    for name, g, jg in pairs:
        np.testing.assert_allclose(g.numpy(), jg, err_msg=name, **MODEL_TOL)


def test_adamw_step_matches_jax():
    """One AdamW step, compared where it is well conditioned (the rule of
    ``test_torch_sp_strategies_train.py``): the first step moves a
    parameter by about ``lr * g / (|g| + eps)``, so where the JAX gradient
    is below ``100 * eps`` a rounding far inside MODEL_TOL moves the update
    by a tenth of ``lr``; those gradients are held above, every other
    parameter after the step at MODEL_TOL."""
    from repro.launch.train_step import make_train_step as jmake
    from repro_torch.launch.train_step import make_train_step as tmake

    jb, jparams, tb, tparams = _models("qwen3_moe", training=True)
    batch = _loss_batch("qwen3_moe", tb.cfg, seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jgrads = jax.jit(jax.grad(lambda p: jb.loss(p, jbatch)[0]))(jparams)
    jp, _, jm = jax.jit(jmake(jb, lr=1e-3))(jparams, jadamw.adamw_init(jparams), jbatch)
    tp, _, tm = tmake(tb, lr=1e-3)(tparams, tadamw.adamw_init(tparams),
                                   ttrainer.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **MODEL_TOL)
    eps = jadamw.AdamWConfig().eps
    # an expert no entry reached has an exact zero gradient and no update
    conditioned = {name: (np.abs(jg) >= 100 * eps) | (jg == 0)
                   for name, _, jg in _grad_pairs(tp, jgrads, tb.cfg.n_layers)}
    for name, a, b in _grad_pairs(tp, jp, tb.cfg.n_layers):
        keep = conditioned[name]
        np.testing.assert_allclose(a.detach().numpy()[keep], b[keep], err_msg=name, **MODEL_TOL)
    kept = sum(int(k.sum()) for k in conditioned.values())
    assert kept > 0.99 * sum(k.size for k in conditioned.values())


def test_remat_dots_saves_the_router_and_recomputes_the_experts():
    """Under ``"dots"`` the router's product (an ``mm``) is saved and the
    experts' batched products recomputed: the backward's ``mm`` count is
    that of ``"none"``, its ``bmm`` count that of ``"full"``; all three
    policies give the same loss and gradients."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.models import transformer as T

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    saved, policy = [], T.dots_policy

    def recording_policy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append(tuple(args[1].shape))
        return out

    _, _, tb, params = _models("llama4", training=True)
    batch = ttrainer.batch_to_device(_loss_batch("llama4", tb.cfg, seed=1), "cpu")
    leaves = tadamw.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    bwd, results = {}, {}
    for remat in ("none", "full", "dots"):
        bundle = tbuild(tb.cfg.with_(remat=remat), tb.pctx)
        T.dots_policy = recording_policy
        try:
            loss, _ = bundle.loss(params, batch)
            with Count() as c:
                grads = torch.autograd.grad(loss, leaves)
        finally:
            T.dots_policy = policy
        bwd[remat], results[remat] = c.ops, (loss.detach(), grads)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert bwd["dots"][mm] == bwd["none"][mm] < bwd["full"][mm]
    assert bwd["dots"][bmm] == bwd["full"][bmm] > bwd["none"][bmm]
    cfg = tb.cfg
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff * cfg.n_shared_experts
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    # per layer: q, k, v, o, the router and the shared expert's three products
    assert sorted(saved) == sorted([(d, hq), (d, hkv), (d, hkv), (hq, d), (d, E), (d, f),
                                    (d, f), (f, d)] * cfg.n_layers)
    for remat in ("full", "dots"):
        assert torch.equal(results[remat][0], results["none"][0]), remat
        for a, b in zip(results[remat][1], results["none"][1]):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("model", ["qwen3_moe", "pixtral"])
def test_lm_prefill_matches_jax(model):
    jb, jparams, tb, tparams = _models(model)
    assert tb.decode_rollback_safe == jb.decode_rollback_safe is True
    cfg = tb.cfg
    B, S_text, max_len = 2, 12, 48
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_text)).astype(np.int32)
    prefix = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
              if model == "pixtral" else None)
    S = S_text + (cfg.frontend_tokens if prefix is not None else 0)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jl, js = jb.prefill(jparams, jnp.asarray(tokens), jnp.asarray(pos),
                        jb.init_serve_state(B, max_len),
                        None if prefix is None else jnp.asarray(prefix))
    tl, ts = tb.prefill(tparams, torch.from_numpy(tokens), torch.from_numpy(pos),
                        tb.init_serve_state(B, max_len, "cpu"),
                        None if prefix is None else torch.from_numpy(prefix))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]), atol=1e-5, rtol=1e-5)
    for key in ("pos", "len"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    # then decode on from the prefilled slab
    tok = np.asarray([3, 7], np.int32)
    jl, _ = jb.decode_step(jparams, jnp.asarray(tok), js)
    tl, _ = tb.decode_step(tparams, torch.from_numpy(tok), ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


def test_lm_prefill_refuses_sp_degree_above_one():
    _, _, tb, tparams = _models("pixtral", sp_degree=2)
    state = tb.init_serve_state(1, 32, "cpu")
    with pytest.raises(NotImplementedError, match="item 9c"):
        tb.prefill(tparams, torch.zeros((1, 4), dtype=torch.int32),
                   torch.arange(4, dtype=torch.int32)[None], state)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_serving_steps_match_jax(model, paged):
    jb, jparams, tb, tparams = _models(model)
    if not paged:
        _drive(jb, jparams, tb, tparams, jb.init_serve_state(3, 32),
               tb.init_serve_state(3, 32, "cpu"), paged=False)
        return
    n_pages, ps, W = 12, 4, 4
    jstate = jb.init_paged_state(n_pages, ps, 3, W)
    tstate = tb.init_paged_state(n_pages, ps, 3, W, "cpu")
    bt = np.full((3, W), n_pages, np.int32)
    bt[0, :3], bt[1, :2], bt[2, :3] = [11, 4, 7], [2, 9], [0, 5, 10]
    jstate = dict(jstate, block_tables=jnp.asarray(bt))
    tstate["block_tables"].copy_(torch.from_numpy(bt))
    _drive(jb, jparams, tb, tparams, jstate, tstate, paged=True)


ENGINE_KW = dict(max_batch=2, max_len=64, prefill_chunk=8, token_budget=12)


def _run_engines(jb, jparams, tb, tparams, **kw):
    kw = dict(ENGINE_KW, **kw)
    j, t = JEngine(jb, jparams, **kw), TEngine(tb, tparams, device="cpu", **kw)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 90, n) for n in (19, 6, 13)]
    reqs = [(j.submit(p, max_new_tokens=m), t.submit(p, max_new_tokens=m))
            for p, m in zip(prompts, (10, 7, 9))]
    j.run()
    t.run()
    for a, b in reqs:
        assert len(b.output) == a.max_new_tokens and b.output == a.output
    return t


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("model", ["qwen3_moe", "llama4"])
def test_engines_match_the_jax_engine(model, paged):
    jb, jparams, tb, tparams = _models(model)
    t = _run_engines(jb, jparams, tb, tparams, **(dict(page_size=4) if paged else {}))
    assert t.stats()["tokens"] == 26


def test_tokenring_sp4_matches_jax_sp1():
    """Reduced qwen3-moe through TokenRing on 4 virtual ranks with expert
    parallelism (no-drop capacity): loss, aux and every leaf against the
    JAX model at SP 1 on the same batch."""
    from repro_torch.launch.train_step import value_and_grad

    jb, jparams, tb, tparams = _models("qwen3_moe", training=True, sp_degree=4,
                                       strategy="tokenring", **NO_DROP)
    batch = _batch(tb.cfg.vocab_size, 2, 64, seed=6, layout="zigzag", sp_degree=4)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tb.pctx.ring.reset_counts()
    (loss, m), grads = value_and_grad(tb.loss, tparams, ttrainer.batch_to_device(batch, "cpu"))
    assert tb.pctx.ring.position_bytes["fwd"] > 0  # the expert-id tables travelled
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    np.testing.assert_allclose(float(m["aux_loss"]), float(jm["aux_loss"]), **MODEL_TOL)
    for name, g, jg in _grad_pairs(grads, jgrads, tb.cfg.n_layers):
        np.testing.assert_allclose(g.numpy(), jg, err_msg=name, **MODEL_TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sp4_engines_match_the_jax_sp1_engine(paged):
    """The port's engines over 4 virtual ranks (expert-parallel chunks and
    replicated-sequence decode, no-drop capacity) against the JAX engine at
    SP 1: every token equal."""
    jb, jparams, tb, tparams = _models("qwen3_moe", sp_degree=4, **NO_DROP)
    _run_engines(jb, jparams, tb, tparams, **(dict(page_size=4) if paged else {}))


def test_serving_layout_dtypes():
    """Serving: expert stacks and the shared expert in cfg.dtype, the router
    in param_dtype, from init and from the JAX tree alike."""
    cfg = TARCHS["llama4-scout-17b-a16e"].reduced(**SMALL, dtype="bfloat16")
    tb = tbuild(cfg, TPctx(impl="torch", device="cpu"))
    jcfg = JARCHS["llama4-scout-17b-a16e"].reduced(**SMALL, dtype="bfloat16")
    jparams = jbuild(jcfg, JPctx(mesh=None, impl="xla")).init(jax.random.PRNGKey(0))
    for params in (tb.init(0), from_jax_params(cfg, jax.tree.map(np.asarray, jparams),
                                               device="cpu")):
        moe = params["layers"][1]["moe"]
        assert {moe[k].dtype for k in ("wg", "wu", "wd")} == {torch.bfloat16}
        assert {t.dtype for _, t in flat_leaves(moe["shared"])} == {torch.bfloat16}
        assert moe["router"]["w"].dtype == torch.float32
        assert params["layers"][0]["ln1"]["scale"].dtype == torch.float32
    train = from_jax_params(cfg, jax.tree.map(np.asarray, jparams), device="cpu", training=True)
    assert {p.dtype for p in tadamw.tree_leaves(train)} == {torch.float32}


def test_clis_run_the_moe_family_on_the_cpu(capsys):
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train

    hist = train(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu", "--steps", "2",
                  "--batch", "2", "--seq", "32"])
    assert len(hist) == 2 and all(np.isfinite(hist))
    out = capsys.readouterr().out
    assert "aux" in out and "ce" in out and "final step 2" in out
    s = serve(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device", "cpu", "--requests", "3",
               "--max-new", "4", "--page-size", "8", "--max-pages", "12"])
    assert s["tokens"] == 12
    s = serve(["--arch", "pixtral-12b", "--reduced", "--device", "cpu", "--requests", "2",
               "--max-new", "3"])
    assert s["tokens"] == 6


@pytest.mark.parametrize("family", ["ssm", "hybrid", "encdec"])
def test_build_model_refuses_the_families_still_to_port(family):
    cfg = TARCHS["qwen3-1.7b"].reduced(family=family)
    with pytest.raises(NotImplementedError, match="items 9a and 9b"):
        tbuild(cfg, TPctx(impl="torch", device="cpu"))

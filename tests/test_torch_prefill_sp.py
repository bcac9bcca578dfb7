"""The one-shot prefill at SP > 1 (``repro_torch.models.transformer
.lm_prefill``, ROADMAP queue 1 item 9c) against the JAX ``lm_prefill`` at
SP 1, on the same numpy inputs with the JAX ``init_lm`` parameters carried
across.

* reduced qwen3-1.7b at SP 2 and 4, reduced pixtral with its patch
  embeddings at SP 4 and reduced qwen3-moe (a capacity at which nothing
  drops) at SP 2, on the virtual ring under TokenRing: the last position's
  logits, every row's K/V, positions and length after the slab's SP layout
  is mapped back to global slots, and the decode steps after it (greedy:
  the same tokens as SP 1's; their logits against the JAX steps fed those
  tokens);
* the same on a gloo group of 4 spawned ranks (``_prefill_pg_worker.py``):
  replicated inputs, each rank's slab shard and the replicated logits.

Float32; logits within 1e-4 and K/V within 1e-5
(``test_torch_serving.py``'s limits), positions and lengths exact.
"""

import dataclasses
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.models import build_model as jbuild
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
KV_TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
             vocab_size=97, moe_d_ff=32)
MODELS = {"dense": ("qwen3-1.7b", {}), "pixtral": ("pixtral-12b", {}),
          # 8 experts, top 2: a factor of E / K drops nothing at any SP degree
          "qwen3_moe": ("qwen3-moe-30b-a3b", dict(capacity_factor=4.0))}
B, S_TEXT, MAX_LEN, STEPS = 2, 16, 64, 6
SPAWN_TIMEOUT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(model):
    name, over = MODELS[model]
    return (JARCHS[name].reduced(**dict(SMALL, **over)),
            TARCHS[name].reduced(**dict(SMALL, **over)))


def _case(model):
    """The JAX bundle and parameters, the prompt (patch embeddings first for
    pixtral) and the JAX prefill plus greedy decode at SP 1: ``(jb,
    jparams, inputs, want)``."""
    jcfg, tcfg = _configs(model)
    jb = jbuild(jcfg, JPctx(mesh=None, impl="xla"))
    jparams = jb.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(len(model))
    tokens = rng.integers(0, tcfg.vocab_size, (B, S_TEXT)).astype(np.int32)
    prefix = (rng.standard_normal((B, tcfg.frontend_tokens, tcfg.d_model)).astype(np.float32)
              if tcfg.frontend_tokens else None)
    S = S_TEXT + (0 if prefix is None else prefix.shape[1])
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    logits, state = jb.prefill(jparams, jnp.asarray(tokens), jnp.asarray(pos),
                               jb.init_serve_state(B, MAX_LEN),
                               None if prefix is None else jnp.asarray(prefix))
    slab = {k: np.asarray(v) for k, v in state.items()}
    rows, feed = [np.asarray(logits)], []
    step = jax.jit(jb.decode_step)
    for _ in range(STEPS):
        tok = np.asarray(rows[-1]).argmax(-1).astype(np.int32)
        feed.append(tok)
        logits, state = step(jparams, jnp.asarray(tok), state)
        rows.append(np.asarray(logits))
    inputs = dict(tokens=tokens, pos=pos, max_len=np.asarray(MAX_LEN),
                  feed=np.stack(feed, 1))
    if prefix is not None:
        inputs["prefix"] = prefix
    return jb, jparams, inputs, dict(logits=np.stack(rows, 1), **slab)


def _global_slab(x, P, B):
    """The SP dense slab's ``(L, P*B, S_loc, ...)`` (rank-major on the
    virtual ring) or a position table's ``(P*B, S_loc)`` as global slots."""
    if x.ndim == 2:  # (P*B, S_loc)
        return x.reshape(P, B, -1).transpose(1, 0, 2).reshape(B, -1)
    L, _, s_loc = x.shape[:3]
    y = x.reshape(L, P, B, s_loc, *x.shape[3:]).swapaxes(1, 2)
    return y.reshape(L, B, P * s_loc, *x.shape[3:])


def _check(got, want, label):
    np.testing.assert_allclose(got["logits"], want["logits"], err_msg=label, **LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key], want[key], err_msg=f"{label} {key}", **KV_TOL)
    for key in ("pos", "len"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{label} {key}")


def _port_run(tcfg, tparams, inputs, P, feed=None):
    """The port's prefill then STEPS decode steps at SP ``P`` on the virtual
    ring, greedy or fed ``feed``: the slab after the prefill in global
    slots, the logits of every step and the tokens chosen."""
    tb = tbuild(tcfg, TPctx(impl="torch", device="cpu", sp_degree=P, strategy="tokenring"))
    state = tb.init_serve_state(B, MAX_LEN, "cpu")
    prefix = inputs.get("prefix")
    logits, state = tb.prefill(tparams, torch.from_numpy(inputs["tokens"]),
                               torch.from_numpy(inputs["pos"]), state,
                               None if prefix is None else torch.from_numpy(prefix))
    got = {k: state[k].numpy().copy() for k in ("k", "v", "pos", "len")}
    if P > 1:
        got.update({k: _global_slab(got[k], P, B) for k in ("k", "v", "pos")})
    rows, chain = [logits.numpy()], []
    for i in range(STEPS):
        tok = rows[-1].argmax(-1).astype(np.int32) if feed is None else feed[:, i]
        chain.append(tok)
        logits, state = tb.decode_step(tparams, torch.from_numpy(tok), state)
        rows.append(logits.numpy())
    got["logits"] = np.stack(rows, 1)
    return got, np.stack(chain, 1)


@pytest.mark.parametrize("model,P", [("dense", 2), ("dense", 4), ("pixtral", 4),
                                     ("qwen3_moe", 2)])
def test_lm_prefill_at_sp_matches_jax_sp1(model, P):
    jb, jparams, inputs, want = _case(model)
    _, tcfg = _configs(model)
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    got, chain = _port_run(tcfg, tparams, inputs, P, feed=inputs["feed"])
    _check(got, want, f"{model} SP {P}")
    # greedy on its own: the tokens SP 1 picks
    _, greedy = _port_run(tcfg, tparams, inputs, P)
    _, sp1 = _port_run(tcfg, tparams, inputs, 1)
    np.testing.assert_array_equal(greedy, sp1)
    np.testing.assert_array_equal(greedy, inputs["feed"])


def test_lm_prefill_refuses_an_unshardable_prompt():
    """The sequence shards over the ring: a prompt whose length the SP
    degree does not divide is refused."""
    _, tcfg = _configs("dense")
    tb = tbuild(tcfg, TPctx(impl="torch", device="cpu", sp_degree=4))
    params = tb.init(0)
    with pytest.raises(ValueError, match="not divisible"):
        tb.prefill(params, torch.zeros((1, 6), dtype=torch.int32),
                   torch.arange(6, dtype=torch.int32)[None], tb.init_serve_state(1, 32, "cpu"))


def test_lm_prefill_process_group_matches_jax(tmp_path):
    """Four gloo ranks under TokenRing: the replicated prompt prefilled,
    each rank's shard of the slab and every rank's logits (prefill, then
    decode steps fed the JAX greedy tokens) against the JAX model at
    SP 1."""
    from _prefill_pg_worker import run

    P, models = 4, ("dense", "pixtral")
    wants = {}
    for model in models:
        _, jparams, inputs, wants[model] = _case(model)
        _, tcfg = _configs(model)
        np.savez(tmp_path / f"{model}.npz", **inputs)
        torch.save(dataclasses.asdict(tcfg), tmp_path / f"{model}_cfg.pt")
        torch.save(from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu"),
                   tmp_path / f"{model}_params.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, P, str(tmp_path / "init"), str(tmp_path), models,
                                           str(tmp_path / f"rank{r}.npz")))
             for r in range(P)]
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
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(P)]
    for model in models:
        pre = f"{model}/"
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[pre + "logits"], ranks[0][pre + "logits"])
            np.testing.assert_array_equal(r[pre + "len"], ranks[0][pre + "len"])
        got = {"logits": ranks[0][pre + "logits"], "len": ranks[0][pre + "len"],
               "pos": np.concatenate([r[pre + "pos"] for r in ranks], axis=1),
               **{k: np.concatenate([r[pre + k] for r in ranks], axis=2) for k in ("k", "v")}}
        _check(got, wants[model], f"gloo {model}")

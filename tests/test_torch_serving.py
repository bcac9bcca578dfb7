"""The port's serving slice against the JAX package: layers, the dense and
paged model steps with JAX ``init_lm`` parameters carried across, and the
engine's greedy chains against the JAX dense teacher-forced oracle
(the convention of ``tests/test_serving.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.models import build_model as jbuild
from repro.models import layers as jlayers
from repro.serving import kv_cache as jkv
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.serving.engine import ServingEngine

from test_serving import _legacy_step, assert_greedy_chain_matches

REDUCED = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
               vocab_size=97)
VARIANTS = {"mha": REDUCED, "gqa": dict(REDUCED, n_heads=4, n_kv_heads=2)}


def _setup(variant="mha"):
    over = VARIANTS[variant]
    jcfg = JARCHS["qwen3-1.7b"].reduced(**over)
    tcfg = TARCHS["qwen3-1.7b"].reduced(**over)
    assert tcfg == type(tcfg)(**{f: getattr(jcfg, f) for f in tcfg.__dataclass_fields__})
    jb = jbuild(jcfg, JPctx(mesh=None, impl="xla"))
    jparams = jb.init(jax.random.PRNGKey(0))
    tb = tbuild(tcfg, TPctx(impl="torch", device="cpu"))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    for nt in ("rmsnorm", "layernorm", "nonparam_ln"):
        jp = {"rmsnorm": {"scale": scale}, "layernorm": {"scale": scale, "bias": scale[::-1]},
              "nonparam_ln": {}}[nt]
        tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
        got = tlayers.apply_norm(tp, torch.from_numpy(x), norm_type=nt)
        want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(x),
                                  norm_type=nt)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6, err_msg=nt)
    for theta in (1e4, 1e6):
        got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    for mt in ("swiglu", "gelu"):
        jp = jlayers.mlp_init(jax.random.PRNGKey(1), 16, 24, mlp_type=mt)
        tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), jp)
        got = tlayers.mlp(tp, torch.from_numpy(h), mlp_type=mt, compute_dtype=torch.float32)
        want = jlayers.mlp(jp, jnp.asarray(h), mlp_type=mt, compute_dtype=jnp.float32)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6, err_msg=mt)


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------


def _check_state(tstate, jstate):
    for key in jstate:
        got, want = _np(tstate[key]), np.asarray(jstate[key])
        if key in ("k", "v"):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def _drive(jb, jparams, tb, tparams, jstate, tstate, paged, view=lambda s: s):
    """Two prefill chunks (ragged, one row skipped) then three decode steps
    (one row inactive), comparing logits and state (seen through ``view``,
    which maps the port's layout to the reference's) after every step."""
    pre = "prefill_chunk_paged" if paged else "prefill_chunk"
    dec = "decode_step_paged" if paged else "decode_step"
    chunks = [
        (np.asarray([[5, 17, 3, 42], [9, 13, 27, 0], [0, 0, 0, 0]], np.int32), [4, 3, 0]),
        (np.asarray([[8, 2, 0, 0], [0, 0, 0, 0], [61, 7, 22, 11]], np.int32), [2, 0, 4]),
    ]
    for toks, n_valid in chunks:
        jl, jstate = jax.jit(getattr(jb, pre))(jparams, jnp.asarray(toks), jstate,
                                              jnp.asarray(n_valid, jnp.int32))
        tl, tstate = getattr(tb, pre)(tparams, torch.from_numpy(toks), tstate,
                                      torch.tensor(n_valid, dtype=torch.int32))
        live = np.asarray(n_valid) > 0
        np.testing.assert_allclose(_np(tl)[live], np.asarray(jl)[live], atol=1e-4, rtol=1e-4)
        _check_state(view(tstate), jstate)
    for step, active in enumerate(([1, 1, 1], [1, 0, 1], [1, 1, 1])):
        toks = np.asarray([3 + step, 40, 77], np.int32)
        act = np.asarray(active, bool)
        jl, jstate = jax.jit(getattr(jb, dec))(jparams, jnp.asarray(toks), jstate,
                                              jnp.asarray(act))
        tl, tstate = getattr(tb, dec)(tparams, torch.from_numpy(toks), tstate,
                                      torch.from_numpy(act))
        np.testing.assert_allclose(_np(tl)[act], np.asarray(jl)[act], atol=1e-4, rtol=1e-4)
        _check_state(view(tstate), jstate)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_steps_match_jax(variant):
    jb, jparams, tb, tparams = _setup(variant)
    _drive(jb, jparams, tb, tparams, jb.init_serve_state(3, 32),
           tb.init_serve_state(3, 32, "cpu"), paged=False)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_paged_steps_match_jax(variant):
    """Reversed, non-contiguous page assignment with sentinel tails."""
    jb, jparams, tb, tparams = _setup(variant)
    n_pages, ps, W = 12, 4, 4
    jstate = jb.init_paged_state(n_pages, ps, 3, W)
    tstate = tb.init_paged_state(n_pages, ps, 3, W, "cpu")
    bt = np.full((3, W), n_pages, np.int32)
    bt[0, :3] = [11, 4, 7]
    bt[1, :2] = [2, 9]
    bt[2, :3] = [0, 5, 10]
    jstate = dict(jstate, block_tables=jnp.asarray(bt))
    tstate["block_tables"].copy_(torch.from_numpy(bt))
    _drive(jb, jparams, tb, tparams, jstate, tstate, paged=True)


# ---------------------------------------------------------------------------
# engine: teacher-forced against the JAX dense decode oracle
# ---------------------------------------------------------------------------


def _engine_case(paged, variant="mha", **kw):
    jb, jparams, tb, tparams = _setup(variant)
    eng = ServingEngine(tb, tparams, max_batch=2, max_len=64, device="cpu",
                        page_size=4 if paged else None, **kw)
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(1, 90, n), max_new_tokens=m)
            for n, m in ((9, 12), (5, 6), (13, 8))]
    done = eng.run()
    assert len(done) == 3
    step = _legacy_step(jb)
    for r in reqs:
        assert len(r.output) == r.max_new_tokens
        assert_greedy_chain_matches(jb, jparams, r, 2, 64, step)
    return eng


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_engine_chains_match_jax_oracle(mode):
    eng = _engine_case(mode == "paged", prefill_chunk=4, token_budget=6)
    s = eng.stats()
    assert s["tokens"] == 26 and s["prefill_tokens"] == 8 + 4 + 12
    assert s["mean_latency_s"] >= s["mean_ttft_s"] >= 0.0


def test_engine_paged_preemption_matches_jax_oracle():
    """An 8-page pool forces recompute preemption; the resumed chains stay
    within GREEDY_TOL of the oracle and every page returns."""
    eng = _engine_case(True, variant="gqa", prefill_chunk=4, max_pages=8)
    s = eng.stats()
    assert s["preemptions"] >= 1
    assert s["pages"]["pages_in_use"] == 0


def test_engine_eos_and_knobs():
    jb, jparams, tb, tparams = _setup()
    eng = ServingEngine(tb, tparams, max_batch=2, max_len=64, device="cpu")
    ref = eng.submit([5, 17, 3, 42], max_new_tokens=6)
    eng.run()
    eos = ref.output[2]
    k = ref.output.index(eos)
    eng2 = ServingEngine(tb, tparams, max_batch=2, max_len=64, device="cpu")
    req = eng2.submit([5, 17, 3, 42], max_new_tokens=6, eos_id=eos)
    eng2.run()
    assert req.stopped_eos and req.output == ref.output[:k]
    assert eng2.stats()["eos_stops"] == 1 and eng2.stats()["tokens"] == k
    with pytest.raises(ValueError, match="prefill_chunk"):
        ServingEngine(tb, tparams, max_batch=1, max_len=32, prefill_chunk=0, device="cpu")
    with pytest.raises(ValueError, match="token_budget"):
        ServingEngine(tb, tparams, max_batch=1, max_len=32, token_budget=0, device="cpu")
    with pytest.raises(ValueError, match="cannot fit"):
        eng.submit(list(range(64)), max_new_tokens=1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=1)


def test_temperature_sampling_is_seeded():
    _, _, tb, tparams = _setup()
    outs = []
    for _ in range(2):
        eng = ServingEngine(tb, tparams, max_batch=2, max_len=64, device="cpu",
                            temperature=1.0, seed=7)
        outs.append(eng.submit([5, 17, 3], max_new_tokens=8))
        eng.run()
    assert outs[0].output == outs[1].output
    assert all(0 <= t < 97 for t in outs[0].output)


def test_page_pool_state_matches_jax_layout():
    jstate = jkv.init_paged_cache(2, 2, 32, n_pages=5, page_size=4, max_batch=3, slot_pages=2,
                                  dtype=jnp.float32)
    _, _, tb, _ = _setup()
    tstate = tb.init_paged_state(5, 4, 3, 2, "cpu")
    for key in jstate:
        assert tuple(tstate[key].shape) == jstate[key].shape, key
        np.testing.assert_array_equal(_np(tstate[key]), np.asarray(jstate[key]), err_msg=key)

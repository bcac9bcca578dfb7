"""The port's SSM family (``repro_torch.models.mamba``, falcon-mamba-7b)
against the JAX package's ``repro.models.mamba`` on the same numpy inputs,
with the JAX ``init_mamba_lm`` parameters carried across
(``from_jax_params``).

* the config field by field, and the full config's parameter count near
  7e9 (``tests/test_smoke_archs.py``'s check) and equal to the JAX tree's;
* the pieces at ``reduced(vocab_size=97)``: ``_causal_conv``,
  ``_summary_pass``, ``_selective_scan_local`` (chunks that do not divide
  S included, a nonzero incoming state), ``mamba_layer``;
* ``mamba_loss`` and every leaf's gradient at SP 1 (remat ``"none"`` and
  ``"full"``) and through ``sp_scan`` at P = 2, 4, 8 and 2 x 2 pods on the
  virtual ring, against the JAX loss and gradients at SP 1; the largest
  scan transient one chunk's (no ``(B, S, d_inner, N)`` tensor);
* a gloo group of 4 spawned ranks (``_mamba_pg_worker.py``): ``sp_scan``
  (flat and 2 x 2 pods) against the sequential oracle and the JAX
  gradients, and the loss and gradients against the JAX model at SP 1;
* ``mamba_decode_step`` over a prompt against the JAX decode step (logits
  and state) and against the port's own forward at every position;
* the bundle: the serving layout's dtypes, the engine's refusal (the
  counterpart of ``tests/test_serving.py``'s), ``build_model`` on the
  ``"hybrid"`` family (ported beside it), the ``Trainer`` against the JAX
  ``Trainer``, the CLIs.

Float32 throughout.  Model-level limits are ``MODEL_TOL`` of
``test_torch_training.py`` (atol 2e-5, rtol 2e-4); the pieces, whose sums
are short, atol/rtol 1e-5; decode logits 1e-4 (``test_torch_serving.py``'s).
"""

import dataclasses
import math
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import _batch, _grad_pairs
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.data import synthetic as jsyn
from repro.models import build_model as jbuild
from repro.models import mamba as jm
from repro.runtime import trainer as jtrainer
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.data import synthetic as tsyn
from repro_torch.models import mamba as tm
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import trainer as ttrainer
from repro_torch.serving.engine import ServingEngine as TEngine

MODEL_TOL = dict(atol=2e-5, rtol=2e-4)
PIECE_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
NAME = "falcon-mamba-7b"
SMALL = dict(vocab_size=97, n_layers=2)
SPAWN_TIMEOUT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(training=True, sp_degree=1, pods=1, **over):
    jcfg = JARCHS[NAME].reduced(**dict(SMALL, **over))
    tcfg = TARCHS[NAME].reduced(**dict(SMALL, **over))
    jb = jbuild(jcfg, JPctx(mesh=None))
    jparams = jb.init(jax.random.PRNGKey(3))
    tb = tbuild(tcfg, TPctx(impl="torch", device="cpu", sp_degree=sp_degree, pods=pods))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
                              training=training)
    return jb, jparams, tb, tparams


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().numpy()


def _value_and_grad(tb, tparams, batch):
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = tb.loss(tparams, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return float(loss.detach()), jax.tree.map(lambda _: next(it), tparams,
                                     is_leaf=lambda x: isinstance(x, torch.Tensor))


def _check_grads(tgrads, jgrads, n_layers, tol=MODEL_TOL):
    pairs = _grad_pairs(tgrads, jgrads, n_layers)
    assert len(pairs) == len(tree_leaves(tgrads))
    for name, a, b in pairs:
        np.testing.assert_allclose(_np(a), b, err_msg=name, **tol)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_config_matches_jax():
    assert dataclasses.asdict(TARCHS[NAME]) == dataclasses.asdict(JARCHS[NAME])
    assert TARCHS[NAME].layout == "contig" and not TARCHS[NAME].tie_embeddings


def test_full_config_parameter_count_near_7e9():
    """On the meta device: shapes only, nothing allocated."""
    cfg = TARCHS[NAME]
    params = tm.init_mamba_lm(cfg, torch.Generator(device="cpu").manual_seed(0),
                              device="meta", training=True)
    n = sum(p.numel() for p in tree_leaves(params))
    assert 0.65 * 7e9 < n < 1.45 * 7e9, n
    specs = jax.eval_shape(lambda k: jm.init_mamba_lm(JARCHS[NAME], k), jax.random.PRNGKey(0))
    assert n == sum(math.prod(x.shape) for x in jax.tree.leaves(specs))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def _scan_pieces(seed, B, S, di, N):
    rng = np.random.default_rng(seed)
    x_c = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = (0.05 * rng.uniform(0.1, 2.0, (B, S, di))).astype(np.float32)
    Bs = rng.standard_normal((B, S, N)).astype(np.float32)
    Cs = rng.standard_normal((B, S, N)).astype(np.float32)
    A = np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (di, N))).copy()
    D = rng.standard_normal((di,)).astype(np.float32)
    h_in = rng.standard_normal((B, di, N)).astype(np.float32)
    return x_c, dt, Bs, Cs, A, D, h_in


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    got = tm._causal_conv(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm._causal_conv(x, w, b)), **PIECE_TOL)
    # a halo of zeros is the default's zero padding
    halo = torch.zeros((2, 3, 16))
    assert torch.equal(tm._causal_conv(_t(x), _t(w), _t(b), halo), got)


@pytest.mark.parametrize("S,chunk", [(32, 16), (24, 16), (24, 5), (16, 32)],
                         ids=["divides", "halves-once", "halves-twice", "longer-than-S"])
def test_summary_and_emit_passes_match_jax(S, chunk):
    x_c, dt, Bs, Cs, A, D, h_in = _scan_pieces(S * 100 + chunk, 2, S, 12, 4)
    tA, th = tm._summary_pass(_t(x_c), _t(dt), _t(Bs), _t(A), chunk)
    jA, jh = jm._summary_pass(*map(jnp.asarray, (x_c, dt, Bs, A)), chunk)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), **PIECE_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **PIECE_TOL)
    ty, tl = tm._selective_scan_local(*map(_t, (x_c, dt, Bs, Cs, A, D, h_in)), chunk)
    jy, jl = jm._selective_scan_local(*map(jnp.asarray, (x_c, dt, Bs, Cs, A, D, h_in)), chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **PIECE_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **PIECE_TOL)


def test_mamba_layer_matches_jax():
    jb, jparams, tb, tparams = _models()
    cfg = tb.cfg
    x = np.random.default_rng(4).standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    jp0 = jax.tree.map(lambda a: a[0], jparams["layers"])
    want = jm.mamba_layer(jp0, jnp.asarray(x), cfg=jb.cfg, pctx=jb.pctx)
    with torch.no_grad():
        got = tm.mamba_layer(tparams["layers"][0], _t(x), cfg=cfg, pctx=tb.pctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------


def _jax_loss_and_grads(jb, jparams, batch):
    (loss, _), grads = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), grads


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_jax_at_sp1(remat):
    jb, jparams, tb, tparams = _models(remat=remat)
    batch = _batch(97, 2, 64, seed=1)
    jloss, jgrads = _jax_loss_and_grads(jb, jparams, batch)
    tloss, tgrads = _value_and_grad(tb, tparams, batch)
    np.testing.assert_allclose(tloss, jloss, **MODEL_TOL)
    _check_grads(tgrads, jgrads, tb.cfg.n_layers)


@pytest.mark.parametrize("P,pods", [(2, 1), (4, 1), (8, 1), (4, 2)],
                         ids=["P2", "P4", "P8", "pods2x2"])
def test_loss_and_gradients_through_the_scan_match_jax_sp1(P, pods):
    """The scan over P virtual ranks (the sequence sharded contiguously,
    128 tokens: 16 a rank at P = 8, one chunk) against the JAX model at
    SP 1."""
    jb, jparams, _, _ = _models()
    _, _, tb, tparams = _models(sp_degree=P, pods=pods)
    batch = _batch(97, 2, 128, seed=2)
    jloss, jgrads = _jax_loss_and_grads(jb, jparams, batch)
    tloss, tgrads = _value_and_grad(tb, tparams, batch)
    np.testing.assert_allclose(tloss, jloss, **MODEL_TOL)
    _check_grads(tgrads, jgrads, tb.cfg.n_layers)
    assert tb.pctx.ring.link_bytes["fwd"] > 0 and tb.pctx.ring.link_bytes["bwd"] > 0


class _Shapes(TorchDispatchMode):
    """Every op's output shapes, forward and backward."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree.leaves(out, is_leaf=lambda x: isinstance(x, torch.Tensor)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("P", [1, 4])
def test_largest_scan_transient_is_one_chunk(P):
    """No ``(B, S, d_inner, N)`` tensor on the training path: the largest
    state-shaped tensor of the loss and its backward is one chunk's a rank
    (``(P*B, chunk, d_inner, N)`` on the virtual ring's folded ranks)."""
    _, _, tb, tparams = _models(sp_degree=P, remat="full")
    cfg = tb.cfg
    B, S = 2, 256
    batch = {k: _t(v) for k, v in _batch(97, B, S, seed=3).items()}
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    with _Shapes() as rec:
        loss, _ = tb.loss(tparams, batch)
        n_fwd = len(rec.shapes)
        torch.autograd.grad(loss, leaves)
    assert len(rec.shapes) > 2 * n_fwd  # the backward (and its recomputes) ran under the mode
    di, N, chunk = cfg.d_inner, cfg.ssm_state, cfg.scan_chunk
    state = [s for s in rec.shapes if len(s) == 4 and s[-2:] == (di, N)]
    assert max(math.prod(s) for s in state) == P * B * chunk * di * N
    assert max(s[1] for s in state) == chunk
    assert all(math.prod(s) < B * S * di * N for s in rec.shapes)


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------


def _sequential(a, b):
    h = np.zeros_like(b[:, 0])
    outs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        outs.append(h.copy())
    return np.stack(outs, 1)


def test_process_group_matches_jax(tmp_path):
    """A gloo group of 4 spawned ranks, each holding its contiguous shard:
    ``sp_scan`` flat and on 2 x 2 pods (``check_scan``'s case), and the
    loss, whose token-weighted sum over the ranks and summed gradients are
    held to the JAX model at SP 1.  The conv takes its halo from the
    previous rank."""
    from repro.core import recurrence as jrec

    from _mamba_pg_worker import run

    P = 4
    jb, jparams, tb, tparams = _models()
    rng = np.random.default_rng(17)
    a = rng.uniform(0.5, 0.99, (2, 64, 8)).astype(np.float32)
    b = rng.standard_normal((2, 64, 8)).astype(np.float32)
    w = rng.standard_normal((2, 64, 8)).astype(np.float32)
    np.savez(tmp_path / "scan.npz", a=a, b=b, w=w)
    batch = _batch(97, 2, 64, seed=4)
    np.savez(tmp_path / "batch.npz", **batch)
    torch.save(tparams, tmp_path / "params.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, P, str(tmp_path / "init"), str(tmp_path),
                                           str(tmp_path / f"rank{r}.npz")))
             for r in range(P)]
    for p in procs:
        p.start()
    try:
        # the JAX oracles while the ranks run
        jloss, jgrads = _jax_loss_and_grads(jb, jparams, batch)
        jga, jgb = jax.grad(lambda a, b: (jrec.local_linear_recurrence(a, b)[0] * w).sum(),
                            argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
        assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(P)]
    summary = 2 * 8 * 4
    from repro_torch.core.recurrence import scan_comm_bytes

    for pods in (1, 2):
        cat = {k: np.concatenate([r[f"scan{pods}/{k}"] for r in ranks], axis=1)
               for k in ("h", "ga", "gb")}
        np.testing.assert_allclose(cat["h"], _sequential(a, b), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(cat["ga"], np.asarray(jga), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(cat["gb"], np.asarray(jgb), atol=1e-5, rtol=1e-5)
        want = scan_comm_bytes(P, summary)["link_bytes"]
        for r in ranks:
            assert (float(r[f"scan{pods}/link_fwd"]), float(r[f"scan{pods}/link_bwd"])) == (
                want["fwd"], want["bwd"])
    denom = sum(float(r["denom"]) for r in ranks)
    loss = sum(float(r["loss"]) * float(r["denom"]) for r in ranks) / denom
    np.testing.assert_allclose(loss, jloss, **MODEL_TOL)
    pairs = _grad_pairs(tparams, jgrads, tb.cfg.n_layers)
    assert len(pairs) == sum(1 for k in ranks[0].files if k.startswith("grad/"))
    for name, _, jg in pairs:
        g = sum(r["grad/params." + name] for r in ranks) / denom
        np.testing.assert_allclose(g, jg, err_msg=name, **MODEL_TOL)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def test_decode_steps_match_jax_and_the_forward():
    """A 12-token prompt fed one token a step through ``mamba_decode_step``:
    every step's logits and the state against the JAX decode step, and the
    logits at every position against the port's own forward pass plus the
    head."""
    jb, jparams, tb, tparams = _models(training=False)
    cfg = tb.cfg
    B, S = 2, 12
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jstate = jb.init_serve_state(B, 64)
    tstate = tb.init_serve_state(B, 64, "cpu")
    step = jax.jit(jb.decode_step)
    rows = []
    for t in range(S):
        jl, jstate = step(jparams, jnp.asarray(tokens[:, t]), jstate)
        tl, tstate = tb.decode_step(tparams, _t(tokens[:, t]), tstate)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {t}", **LOGIT_TOL)
        rows.append(tl)
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]), **PIECE_TOL)
    with torch.no_grad():
        x = tm.mamba_apply(tparams, _t(tokens), cfg=cfg, pctx=tb.pctx)
        fwd = x @ tparams["lm_head"]["w"]
    np.testing.assert_allclose(torch.stack(rows, 1).numpy(), fwd.numpy(), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------


def test_serving_layout_keeps_dt_proj_in_float32():
    """Serving stores the dense weights in the compute dtype but
    ``dt_proj``, which computes in float32, as the JAX decode step does;
    training keeps every leaf in ``param_dtype``."""
    cfg = TARCHS[NAME].reduced(vocab_size=97, n_layers=1, dtype="bfloat16")
    jparams = jm.init_mamba_lm(JARCHS[NAME].reduced(vocab_size=97, n_layers=1,
                                                    dtype="bfloat16"), jax.random.PRNGKey(0))
    for params in (tbuild(cfg, TPctx(device="cpu")).init(0),
                   from_jax_params(cfg, jax.tree.map(np.asarray, jparams), device="cpu")):
        p0 = params["layers"][0]
        for key in ("in_proj", "x_proj", "out_proj"):
            assert p0[key]["w"].dtype == torch.bfloat16, key
        assert params["embed"]["table"].dtype == params["lm_head"]["w"].dtype == torch.bfloat16
        assert p0["dt_proj"]["w"].dtype == p0["dt_proj"]["b"].dtype == torch.float32
        for key in ("conv_w", "conv_b", "A_log", "D"):
            assert p0[key].dtype == torch.float32, key
    for t in tree_leaves(tbuild(cfg, TPctx(device="cpu")).init(0, training=True)):
        assert t.dtype == torch.float32


def test_engine_refuses_falcon_mamba():
    """The counterpart of ``tests/test_serving.py``'s refusal: the recurrent
    state cannot be rolled back per slot, so the engine refuses the bundle
    with the JAX message."""
    jb, _, tb, tparams = _models(training=False)
    assert tb.decode_rollback_safe is jb.decode_rollback_safe is False
    assert tb.prefill_chunk is tb.prefill is tb.decode_step_paged is None
    with pytest.raises(NotImplementedError, match="rolled back"):
        TEngine(tb, tparams, max_batch=2, max_len=32, device="cpu")


def test_build_model_refuses_the_hybrid_family_with_its_pointer():
    """The hybrid family, once refused with a pointer to its slice, is
    ported: the JAX config's fields build the port's hybrid bundle, whose
    recurrent state, like falcon-mamba's, cannot be rolled back per slot."""
    fields = dataclasses.asdict(JARCHS["recurrentgemma-2b"])
    cfg = TArchConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})
    assert cfg == TARCHS["recurrentgemma-2b"]
    bundle = tbuild(cfg.reduced(), TPctx(impl="torch", device="cpu"))
    assert bundle.cfg.family == "hybrid" and bundle.decode_rollback_safe is False
    assert bundle.prefill_chunk is bundle.prefill is bundle.decode_step_paged is None


def test_trainer_matches_jax_trainer():
    """Three steps of the port's ``Trainer`` at SP 1 and through the scan
    at SP 4 against the JAX ``Trainer`` from the same parameters."""
    jb, _, tb, _ = _models()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    data = dict(vocab_size=97, seq_len=64, global_batch=2, seed=0, layout="contig")
    jt = jtrainer.Trainer(jb, jtrainer.TrainerConfig(**kw))
    js = jt.init_state(jax.random.PRNGKey(1))
    start = jax.tree.map(np.asarray, js["params"])
    js, jhist = jt.run(js, jsyn.SyntheticDataset(jsyn.SyntheticConfig(**data)), steps=3,
                       log=lambda *a: None)
    for P in (1, 4):
        _, _, tb, _ = _models(sp_degree=P)
        tr = ttrainer.Trainer(tb, ttrainer.TrainerConfig(**kw))
        state = tr.state_from_params(from_jax_params(tb.cfg, start, device="cpu",
                                                     training=True))
        ts, thist = tr.run(state, tsyn.SyntheticDataset(tsyn.SyntheticConfig(**data)),
                           steps=3, log=lambda *a: None)
        np.testing.assert_allclose(thist, jhist, err_msg=f"SP {P}", **MODEL_TOL)
        for name, a, b in _grad_pairs(ts["params"], js["params"], tb.cfg.n_layers):
            np.testing.assert_allclose(_np(a), b, err_msg=f"SP {P} {name}", **MODEL_TOL)


def test_clis(capsys):
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train

    hist = train(["--arch", NAME, "--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                  "--seq", "64", "--sp-degree", "4"])
    assert len(hist) == 2 and all(np.isfinite(hist))
    out = capsys.readouterr().out
    assert "the chunked scan over 4 virtual ranks" in out and "final step 2" in out
    with pytest.raises(NotImplementedError, match="rolled back"):
        serve(["--arch", NAME, "--reduced", "--device", "cpu", "--requests", "2"])

"""The encoder-decoder family of the port (whisper-base, reduced: 2 encoder
and 4 decoder layers, d 128, ``enc_seq`` 64, vocab 97, float32) against
the JAX package, on the same numpy inputs with the JAX ``init_encdec``
parameters carried across (``from_jax_params``): the configs field by field,
the sinusoids, ``encdec_loss`` and every leaf's gradient under each remat
policy with and without a mask, ``cross_attention`` and ``encode_kv``,
encode-then-decode, TokenRing over 4 ranks (the virtual ring and a gloo
group, ``tests/_encdec_pg_worker.py``), the Trainer with a frames source,
the engine's token-by-token prefill against the JAX engine, the serve CLI
and the bundle ``build_model`` returns.

Oracles: every case holds the port against the JAX model at SP 1.  Ring
attention is exact up to the order of its merges, so SP 1 is a sound
oracle for the port's SP 4 runs too.  The decode is held against the JAX
*forward pass* (``_encoder``, ``_decoder`` and the tied head, teacher
forced), not the JAX decode step, whose cross-attention is causal
(``sp_decode`` hard-codes it): a decoder token at position t there sees
only encoder frames 0..t, which training never does (ROADMAP queue 3
item 9).  ``test_decode_matches_the_jax_forward`` pins that difference.

Limits: ``MODEL_TOL`` (atol 2e-5, rtol 2e-4) for losses and gradients,
1e-4 for logits, as in ``test_torch_families.py``.
"""

import dataclasses
import multiprocessing as mp
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_engine import JEngine

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.data import synthetic as jsyn
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro.models import encdec as JE
from repro.runtime import trainer as jtrainer
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as TE
from repro_torch.models.config import ArchConfig as TArchConfig
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.runtime import trainer as ttrainer
from repro_torch.serving.engine import ServingEngine as TEngine

MODEL_TOL = dict(atol=2e-5, rtol=2e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper-base"
VOCAB = 97
S_DEC = 32
SPAWN_TIMEOUT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(*tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def _models(training=False, sp_degree=1, **over):
    jcfg = JARCHS[ARCH].reduced(vocab_size=VOCAB, **over)
    tcfg = TARCHS[ARCH].reduced(vocab_size=VOCAB, **over)
    jb = jbuild(jcfg, JPctx(mesh=None, impl="xla"))
    jparams = jb.init(jax.random.PRNGKey(3))
    tb = tbuild(tcfg, TPctx(impl="torch", device="cpu", sp_degree=sp_degree,
                            strategy="tokenring"))
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
                              training=training)
    return jb, jparams, tb, tparams


def _frames(cfg, B, tag):
    return _rng("frames", *tag).standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)


def _batch(cfg, B=2, S=S_DEC, tag=(), mask=False):
    rng = _rng("batch", *tag)
    batch = {"frames": _frames(cfg, B, tag),
             "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()}
    if mask:
        batch["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


def _pairs(tgrads, jgrads):
    """(name, port leaf, JAX leaf) for every parameter; the JAX tree stacks
    each layer list on a leading dim."""
    flat = []

    def walk(t, j, name):
        if isinstance(t, dict):
            assert set(t) == set(j), (name, set(t), set(j))
            for key in t:
                walk(t[key], j[key], f"{name}.{key}")
        elif isinstance(t, list):
            for l, sub in enumerate(t):
                walk(sub, jax.tree.map(lambda a, l=l: np.asarray(a)[l], j), f"{name}[{l}]")
        else:
            flat.append((name, t, np.asarray(j)))

    walk(tgrads, jgrads, "params")
    return flat


def _jax_forward_logits(jb, jparams, frames, tokens):
    """Teacher-forced logits of the JAX forward pass: ``_encoder``,
    ``_decoder`` and the tied head."""
    cfg, pctx = jb.cfg, jb.pctx
    B, S = tokens.shape
    enc_pos = jnp.broadcast_to(jnp.arange(cfg.enc_seq, dtype=jnp.int32)[None], (B, cfg.enc_seq))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    enc_x = JE._encoder(jparams, jnp.asarray(frames), enc_pos, cfg=cfg, pctx=pctx)
    x = JE._decoder(jparams, jnp.asarray(tokens), pos, enc_x, enc_pos, cfg=cfg, pctx=pctx)
    return np.asarray(jnp.einsum("bsd,dv->bsv", x, jparams["embed"]["table"].T))


def test_configs_match_jax_field_by_field():
    j, t = JARCHS[ARCH], TARCHS[ARCH]
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    for jr, tr in ((j.reduced(), t.reduced()), (j.reduced(vocab_size=VOCAB),
                                                t.reduced(vocab_size=VOCAB))):
        assert tr == TArchConfig(**{f: getattr(jr, f) for f in tr.__dataclass_fields__})
    assert (t.n_enc_layers, t.n_layers, t.d_model, t.head_dim, t.enc_seq) == (6, 6, 512, 64, 1536)


@pytest.mark.parametrize("S,d", [(64, 128), (1536, 512), (7, 6)])
def test_sinusoids_match_jax(S, d):
    np.testing.assert_array_equal(TE.sinusoid_positions(S, d).numpy(),
                                  np.asarray(JE.sinusoid_positions(S, d)))


def test_sinusoids_are_made_once_per_shape_and_device():
    """The encoder reads one shared table per (S, d, device): no copy from
    the host at each forward."""
    a = TE.sinusoid_positions(64, 128)
    assert TE.sinusoid_positions(64, 128, torch.device("cpu")) is a
    assert TE.sinusoid_positions(32, 128) is not a


def test_bundle_serves_by_encode_and_token_by_token():
    _, _, tb, _ = _models()
    assert tb.encode is not None and tb.decode_rollback_safe is True
    assert tb.prefill_chunk is tb.decode_step_paged is tb.prefill_chunk_paged is None
    assert tb.init_paged_state is tb.prefill is None
    params = tb.init(0)
    assert params["dec_pos"].shape == (32768, tb.cfg.d_model)
    assert (len(params["enc_layers"]), len(params["dec_layers"])) == (2, 4)
    assert set(params["dec_layers"][0]) == {"ln1", "self", "ln_x", "cross", "ln2", "mlp"}


@pytest.mark.parametrize("mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_and_gradients_match_jax(remat, mask):
    from repro_torch.launch.train_step import value_and_grad

    jb, jparams, tb, tparams = _models(training=True, remat=remat)
    batch = _batch(tb.cfg, tag=("loss", mask), mask=mask)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, m), grads = value_and_grad(tb.loss, tparams, ttrainer.batch_to_device(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    for key in ("ce_loss", "tokens"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), err_msg=key, **MODEL_TOL)
    pairs = _pairs(grads, jgrads)
    assert len(pairs) == sum(
        np.asarray(x).shape[0] if k.endswith("layers") else 1
        for k, sub in jgrads.items() for x in jax.tree.leaves(sub))
    for name, g, jg in pairs:
        np.testing.assert_allclose(g.numpy(), jg, err_msg=name, **MODEL_TOL)


@pytest.mark.parametrize("S", [1, 12])
def test_cross_attention_and_encode_kv_match_jax(S):
    jb, jparams, tb, tparams = _models()
    cfg, B = tb.cfg, 3
    rng = _rng("cross", S)
    enc_x = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = (np.arange(S, dtype=np.int32)[None] + np.asarray([[0], [5], [40]], np.int32))
    enc_pos = np.broadcast_to(np.arange(cfg.enc_seq, dtype=np.int32), (B, cfg.enc_seq)).copy()
    jp = jax.tree.map(lambda a: a[1], jparams["dec_layers"]["cross"])
    tp = tparams["dec_layers"][1]["cross"]
    jk, jv = jattn.encode_kv(jp, jnp.asarray(enc_x), jb.cfg)
    tk, tv = tattn.encode_kv(tp, torch.from_numpy(enc_x), cfg)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **LOGIT_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **LOGIT_TOL)
    y = tattn.cross_attention(tp, torch.from_numpy(x), tk, tv, torch.from_numpy(enc_pos),
                              torch.from_numpy(pos), cfg=cfg, pctx=tb.pctx)
    # the JAX decode-side call (S == 1) is causal, the fault the port fixes:
    # hold S == 1 to the JAX sequence-side (non-causal) call on a repeated row
    xj = np.repeat(x, 2, axis=1) if S == 1 else x
    pj = np.concatenate([pos, pos], axis=1) if S == 1 else pos
    jy = jattn.cross_attention(jp, jnp.asarray(xj), jk, jv, jnp.asarray(enc_pos),
                               jnp.asarray(pj), cfg=jb.cfg, pctx=jb.pctx)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy)[:, :S], **LOGIT_TOL)


@pytest.mark.parametrize("sp_degree", [1, 4])
def test_decode_matches_the_jax_forward(sp_degree):
    """encode, then T = 8 decode steps: every position's logits equal the
    JAX teacher-forced forward pass's (the cross K/V sharded over the ring
    at SP 4).  At position 0 the JAX decode step is far from that forward,
    the causal cross read of ROADMAP queue 3 item 9; the port is not."""
    jb, jparams, tb, tparams = _models(sp_degree=sp_degree)
    cfg, B, T = tb.cfg, 2, 8
    frames = _frames(cfg, B, ("decode",))
    tokens = _rng("decode tokens").integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    ref = _jax_forward_logits(jb, jparams, frames, tokens)
    state = tb.init_serve_state(B, 32, "cpu")
    tb.encode(tparams, torch.from_numpy(frames), state)
    if sp_degree > 1:
        assert state["xk"].shape == (cfg.n_layers, sp_degree * B, cfg.enc_seq // sp_degree,
                                     cfg.n_kv_heads, cfg.head_dim)
    for t in range(T):
        logits, state = tb.decode_step(tparams, torch.from_numpy(tokens[:, t]), state)
        np.testing.assert_allclose(logits.numpy(), ref[:, t], err_msg=f"position {t}",
                                   **LOGIT_TOL)
    assert state["len"].tolist() == [T] * B
    jstate = jb.encode(jparams, jnp.asarray(frames), jb.init_serve_state(B, 32))
    jl, _ = jb.decode_step(jparams, jnp.asarray(tokens[:, 0]), jstate)
    assert np.abs(np.asarray(jl) - ref[:, 0]).max() > 100 * LOGIT_TOL["atol"]


def test_tokenring_sp4_matches_jax_sp1():
    """TokenRing over 4 virtual ranks: the encoder's self-attention and the
    cross-attention non-causal (decoder queries of 32/4 rows circulating
    against resident encoder shards of 64/4 rows, Sq != Sk), the decoder's
    self-attention causal; loss and every leaf against the JAX model at
    SP 1, under remat "full"."""
    from repro_torch.launch.train_step import value_and_grad

    jb, jparams, tb, tparams = _models(training=True, sp_degree=4, remat="full")
    batch = _batch(tb.cfg, tag=("ring",), mask=True)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    ring = tb.pctx.ring
    ring.reset_counts()
    (loss, _), grads = value_and_grad(tb.loss, tparams, ttrainer.batch_to_device(batch, "cpu"))
    assert ring.link_bytes["fwd"] > 0  # the queries travelled
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    for name, g, jg in _pairs(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, err_msg=name, **MODEL_TOL)


def test_process_group_loss_matches_jax(tmp_path):
    """The same loss on a gloo group of 4 spawned ranks: each rank holds
    its contiguous shard of the frames and of the decoder tokens; the
    token-weighted sum of the ranks' losses and the sum of their gradients
    against the JAX model at SP 1."""
    from _encdec_pg_worker import run

    P = 4
    jb, jparams, tb, tparams = _models(training=True)
    batch = _batch(tb.cfg, tag=("gloo",), mask=True)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jb.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.savez(tmp_path / "batch.npz", **batch)
    torch.save(tparams, tmp_path / "params.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, P, str(tmp_path / "init"), str(tmp_path),
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
    denom = sum(float(r["denom"]) for r in ranks)
    loss = sum(float(r["loss"]) * float(r["denom"]) for r in ranks) / denom
    np.testing.assert_allclose(loss, float(jloss), **MODEL_TOL)
    names = [n for n, _, _ in _pairs(tparams, jgrads)]
    assert sorted(names) == sorted(k[len("grad/"):] for k in ranks[0].files
                                   if k.startswith("grad/"))
    for name, _, jg in _pairs(tparams, jgrads):
        g = sum(r["grad/" + name] for r in ranks) / denom
        np.testing.assert_allclose(g, jg, err_msg=name, **MODEL_TOL)


class FramesData:
    """The synthetic token stream with seeded frame embeddings added to
    each batch (the JAX train CLI has no frames source)."""

    def __init__(self, cfg, data_cfg):
        self.cfg = cfg
        self.tokens = jsyn.SyntheticDataset(data_cfg)

    def __iter__(self):
        return self

    def __next__(self):
        step = self.tokens.step
        batch = next(self.tokens)
        B = batch["tokens"].shape[0]
        batch["frames"] = _frames(self.cfg, B, ("trainer", step))
        return batch


def test_trainer_with_frames_matches_jax_trainer():
    """``batch_to_device`` carries ``frames`` through: three AdamW steps of
    the port's Trainer against the JAX Trainer on the same stream."""
    jb, _, tb, _ = _models(training=True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    data = dict(vocab_size=VOCAB, seq_len=S_DEC, global_batch=4, seed=0)
    jt = jtrainer.Trainer(jb, jtrainer.TrainerConfig(**kw))
    js = jt.init_state(jax.random.PRNGKey(1))
    tparams = from_jax_params(tb.cfg, jax.tree.map(np.asarray, js["params"]), device="cpu",
                              training=True)
    js, jhist = jt.run(js, FramesData(jb.cfg, jsyn.SyntheticConfig(**data)), steps=3,
                       log=lambda *a: None)
    tr = ttrainer.Trainer(tb, ttrainer.TrainerConfig(**kw))
    ts, thist = tr.run(tr.state_from_params(tparams),
                       FramesData(tb.cfg, jsyn.SyntheticConfig(**data)), steps=3,
                       log=lambda *a: None)
    np.testing.assert_allclose(thist, jhist, **MODEL_TOL)
    for name, a, b in _pairs(ts["params"], js["params"]):
        np.testing.assert_allclose(a.detach().numpy(), b, err_msg=name, **MODEL_TOL)


@pytest.mark.parametrize("sp_degree", [1, 4])
def test_engine_matches_the_jax_engine(sp_degree):
    """The counterpart of ``test_serving.py::test_fallback_family_without_
    prefill_chunk_still_serves``: 3 requests through 2 slots, prefilled
    token by token (no chunk step), every token equal to the JAX
    engine's."""
    jb, jparams, tb, tparams = _models(sp_degree=sp_degree)
    kw = dict(max_batch=2, max_len=32)
    j, t = JEngine(jb, jparams, **kw), TEngine(tb, tparams, device="cpu", **kw)
    reqs = [(j.submit([3 + i, 9, 27], max_new_tokens=4), t.submit([3 + i, 9, 27],
                                                                  max_new_tokens=4))
            for i in range(3)]
    assert len(j.run(max_steps=100)) == len(t.run(max_steps=100)) == 3
    for a, b in reqs:
        assert len(b.output) == 4 and b.output == a.output
    s = t.stats()
    assert s["prefill_steps"] == 0 and s["decode_steps"] == j.stats()["decode_steps"]


def test_engine_refuses_paged_serving_and_unrollable_state():
    _, _, tb, tparams = _models()
    with pytest.raises(NotImplementedError, match="paged"):
        TEngine(tb, tparams, max_batch=2, max_len=32, page_size=4, device="cpu")
    recurrent = dataclasses.replace(tb, decode_rollback_safe=False)
    with pytest.raises(NotImplementedError, match="rolled back"):
        TEngine(recurrent, tparams, max_batch=2, max_len=32, device="cpu")


def test_serve_cli_runs_whisper_on_the_cpu(capsys):
    from repro_torch.launch.serve import main as serve

    s = serve(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
               "--max-new", "4"])
    assert s["tokens"] == 12 and s["prefill_steps"] == 0
    assert "0 prefill chunks" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="paged"):
        serve(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "1",
               "--page-size", "8"])

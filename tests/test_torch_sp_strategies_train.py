"""The reduced qwen3-1.7b trained through Ulysses and through the 2 x 2
multi-pod hybrid (TokenRing inside each pod) on 4 virtual ranks, against
the JAX model at SP 1 on the same weights and zigzag batch: the loss, every
gradient leaf and the parameters after one AdamW step, at
``test_torch_training.MODEL_TOL`` (a ring computes exactly what full
attention computes).  Then the train CLI through the hybrid on the CPU.

The AdamW step is compared where it is well conditioned: the first step
moves a parameter by about ``lr * g / (|g| + eps)``, so where ``|g|`` is
near AdamW's ``eps`` (1e-8) a gradient rounding of 1e-9 — far inside
MODEL_TOL — moves the update by a tenth of ``lr``.  Parameters whose JAX
gradient is below ``100 * eps`` are held through their gradient (above);
every other parameter after the step at MODEL_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import (  # noqa: F401  (_few_threads: the module fixture)
    MODEL_TOL,
    REDUCED,
    _batch,
    _few_threads,
    _grad_pairs,
    _models,
    _np,
)

from repro.optim import adamw as jadamw
from repro_torch.models.convert import from_jax_params
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import trainer as ttrainer

# Ulysses at P = 4 needs head counts divisible by 4: qwen3-1.7b's GQA ratio
# of 2 (16/8) at 8/4 heads; the hybrid runs the GQA 4/2 variant of the ring test.
PATHS = {
    "ulysses": (dict(REDUCED, n_heads=8, n_kv_heads=4, d_head=16),
                dict(sp_degree=4, strategy="ulysses")),
    "hybrid": (dict(REDUCED, n_heads=4, n_kv_heads=2),
               dict(sp_degree=4, pods=2, strategy="tokenring")),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_lm_through_the_strategy_matches_jax_at_sp1(path):
    from repro.launch.train_step import make_train_step as jmake
    from repro_torch.launch.train_step import make_train_step as tmake
    from repro_torch.launch.train_step import value_and_grad

    over, pctx = PATHS[path]
    jb, tb = _models(dict(over, remat="full"), **pctx)
    jparams = jb.init(jax.random.PRNGKey(6))
    batch = _batch(97, 2, 64, seed=7, layout="zigzag", sp_degree=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(jb.loss, has_aux=True)(jparams, jbatch)
    tparams = from_jax_params(tb.cfg, jax.tree.map(np.asarray, jparams), device="cpu",
                              training=True)
    tbatch = ttrainer.batch_to_device(batch, "cpu")
    tb.pctx.ring.reset_counts()
    (loss, _), grads = value_and_grad(tb.loss, tparams, tbatch)
    plan = tb.pctx.plan(tb.pctx.ring and _shapes(tb.cfg, batch))
    assert (plan.strategy, plan.inner) == {"ulysses": ("ulysses", None),
                                           "hybrid": ("tokenring", "tokenring")}[path]
    sent = tb.pctx.ring.class_bytes
    assert set(sent) == ({"link"} if path == "ulysses" else {"inter", "intra"})
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
    for name, g, jg in _grad_pairs(grads, jgrads, tb.cfg.n_layers):
        np.testing.assert_allclose(_np(g), jg, err_msg=name, **MODEL_TOL)
    jp, _, jm = jmake(jb, lr=1e-3)(jparams, jadamw.adamw_init(jparams), jbatch)
    tp, _, tm = tmake(tb, lr=1e-3)(tparams, tadamw.adamw_init(tparams), tbatch)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **MODEL_TOL)
    eps = jadamw.AdamWConfig().eps
    conditioned = {name: np.abs(jg) >= 100 * eps
                   for name, _, jg in _grad_pairs(grads, jgrads, tb.cfg.n_layers)}
    for name, a, b in _grad_pairs(tp, jp, tb.cfg.n_layers):
        keep = conditioned[name]
        np.testing.assert_allclose(_np(a)[keep], b[keep], err_msg=name, **MODEL_TOL)
    kept = sum(int(k.sum()) for k in conditioned.values())
    assert kept > 0.99 * sum(k.size for k in conditioned.values())


def _shapes(cfg, batch):
    from repro_torch.core.api import AttnShapes

    B, S = batch["tokens"].shape
    return AttnShapes(B=B, Sq=S, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, D=cfg.head_dim,
                      dtype_bytes=4)


def test_train_cli_trains_the_hybrid_on_the_cpu(capsys):
    from repro_torch.launch.train import main

    torch.manual_seed(0)
    hist = main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "64",
                 "--sp-degree", "4", "--pods", "2", "--strategy", "ring"])
    assert len(hist) == 2 and all(np.isfinite(hist))
    out = capsys.readouterr().out
    assert "ring over 4 virtual ranks (2 pods" in out and "final step 2" in out

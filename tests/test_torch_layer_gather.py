"""The per-layer just-in-time FSDP gather (``repro_torch.sharding``:
``gather_step_params``, ``LayerBlocks``, ``layer_params``): every layer
loop gathers its layer inside the remat region.

* every family's ``Trainer`` on the virtual (data 2, model 2) mesh at remat
  ``"full"`` (qwen3, qwen3-moe at capacity factor E / K, pixtral on text
  rows, whisper-base, falcon-mamba, recurrentgemma) against the JAX
  ``Trainer`` at ``mesh=None`` on the same global batch: each step's loss
  and the gathered parameters after three steps, at
  ``test_torch_data_parallel.py``'s ``MODEL_TOL``;
* the ledger's ``"data"`` class equals ``fsdp_comm_bytes`` under remat
  ``"none"``, ``"full"`` and ``"dots"`` and at 2 microbatches;
* the high-water of the gathered bytes alive equals
  ``fsdp_gathered_bytes`` under remat, below the whole tree's bytes;
* dense losses bitwise those of the same global batch on the mesh without
  a data axis.

The gloo group's per-layer gather is in ``test_torch_data_parallel.py``.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_data_parallel import MODEL_TOL, _pairs

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.data import synthetic as jsyn
from repro.models import build_model as jbuild
from repro.runtime import trainer as jtrainer
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import trainer as ttrainer
from repro_torch.sharding import (
    STACKED,
    LayerBlocks,
    fsdp_comm_bytes,
    fsdp_gathered_bytes,
    gather_step_params,
    tree_bytes,
)

STEPS = 3
MESH = dict(data_degree=2, sp_degree=2)
QWEN = "qwen3-1.7b"
QWEN_OVER = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
                 vocab_size=97, logits_chunk=16)

# (arch, overrides, sequence): each family's reduced config at remat "full"
FAMILIES = {
    "qwen3": (QWEN, QWEN_OVER, 64),
    "qwen3-moe": ("qwen3-moe-30b-a3b", dict(capacity_factor=4.0), 64),
    "pixtral": ("pixtral-12b", {}, 64),
    "whisper": ("whisper-base", {}, 32),
    "falcon-mamba": ("falcon-mamba-7b", dict(vocab_size=97), 64),
    "recurrentgemma": ("recurrentgemma-2b", {}, 64),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(cfg):
    """The sequence layout of the data and the ring: the scan and the window
    halo need contiguous shards."""
    return "contig" if cfg.family in ("ssm", "hybrid") else "zigzag"


class _Data:
    """The synthetic stream of ``cfg`` (``repro.data.synthetic``, numpy),
    with seeded encoder frames for an encoder-decoder."""

    def __init__(self, cfg, S, B=4, P=2):
        self.cfg = cfg
        self.tokens = jsyn.SyntheticDataset(jsyn.SyntheticConfig(
            vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=0,
            layout=_layout(cfg), sp_degree=P))

    def __iter__(self):
        return self

    def __next__(self):
        step = self.tokens.step
        batch = next(self.tokens)
        if self.cfg.enc_seq:
            rng = np.random.default_rng([7, step])
            batch["frames"] = rng.standard_normal(
                (batch["tokens"].shape[0], self.cfg.enc_seq, self.cfg.d_model)).astype(
                    np.float32)
        return batch


def _trainer_cfg(**kw):
    return dict(lr=1e-3, warmup_steps=1, total_steps=STEPS, **kw)


def _jax_run(arch, over, S):
    """The JAX Trainer at mesh=None: (initial params as numpy, losses,
    final params)."""
    jb = jbuild(JARCHS[arch].reduced(**over), JPctx(mesh=None, impl="xla"))
    jt = jtrainer.Trainer(jb, jtrainer.TrainerConfig(**_trainer_cfg()))
    js = jt.init_state(jax.random.PRNGKey(1))
    p0 = jax.tree.map(np.asarray, js["params"])
    js, hist = jt.run(js, _Data(jb.cfg, S), steps=STEPS, log=lambda *a: None)
    return p0, hist, jax.tree.map(np.asarray, js["params"])


def _port_trainer(arch, over, mesh=MESH, **tcfg):
    cfg = TARCHS[arch].reduced(**over)
    pctx = TPctx(device="cpu", impl="torch", layout=_layout(cfg), **mesh)
    return ttrainer.Trainer(tbuild(cfg, pctx), ttrainer.TrainerConfig(**_trainer_cfg(**tcfg)))


def _port_run(trainer, S, params=None, steps=STEPS, B=4):
    cfg = trainer.bundle.cfg
    state = (trainer.init_state(0) if params is None else
             trainer.state_from_params(from_jax_params(cfg, params, device="cpu",
                                                       training=True)))
    if trainer.comm is not None:
        trainer.comm.ledger.reset()
    return trainer.run(state, _Data(cfg, S, B=B, P=trainer.bundle.pctx.sp_degree),
                       steps=steps, log=lambda *a: None)


def _bytes_and_high_water(trainer, steps, microbatches=1):
    """The ledger against the closed forms: the data class a direction over
    ``steps``, and the gathered high-water (remat) or below the whole tree
    (none)."""
    layout, ledger = trainer.params_layout, trainer.comm.ledger
    remat = trainer.bundle.cfg.remat
    want = fsdp_comm_bytes(layout, remat, microbatches)
    for way in ("fwd", "bwd"):
        assert ledger.class_bytes["data"][way] == pytest.approx(steps * want[way], rel=1e-12)
    whole = tree_bytes(layout.meta)
    if remat == "none":  # the graph keeps each layer's gathered weights
        assert fsdp_gathered_bytes(layout) < ledger.gathered_high <= whole
    else:
        assert ledger.gathered_high == fsdp_gathered_bytes(layout) < whole
    assert ledger.gathered_live == 0  # every gathered tensor freed after the step


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_per_layer_gather_matches_jax(family):
    """Three steps at remat "full" on the virtual (2, 2) mesh: every layer
    gathered inside its remat region, twice a step."""
    arch, over, S = FAMILIES[family]
    over = dict(over, remat="full")
    p0, jhist, jfinal = _jax_run(arch, over, S)
    trainer = _port_trainer(arch, over)
    state, hist = _port_run(trainer, S, params=p0)
    np.testing.assert_allclose(hist, jhist, **MODEL_TOL)
    for name, a, b in _pairs(trainer.full_params(state), jfinal):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **MODEL_TOL)
    _bytes_and_high_water(trainer, STEPS)


@pytest.mark.parametrize("remat,microbatches",
                         [("none", 1), ("full", 1), ("dots", 1), ("full", 2), ("dots", 2)])
def test_ledger_and_high_water_equal_their_closed_forms(remat, microbatches):
    """qwen3 at 4 layers, two steps: each stacked leaf gathered 1 + (remat
    != "none") times a microbatch, the rest once; the gathered bytes alive
    at once the leaves outside the stacks plus one layer."""
    trainer = _port_trainer(QWEN, dict(QWEN_OVER, remat=remat), microbatches=microbatches)
    _port_run(trainer, 64, steps=2, B=4 * microbatches)
    _bytes_and_high_water(trainer, 2, microbatches)


def test_step_params_hand_each_layer_stack_over_as_blocks():
    """The loss's tree on a mesh: the leaves outside the stacks gathered,
    each entry of a stack (recurrentgemma's superblocks and tail) a
    ``LayerBlocks`` of its blocks."""
    trainer = _port_trainer("recurrentgemma-2b", {})
    state = trainer.init_state(0)
    layout = trainer.params_layout
    tree = gather_step_params(state["params"], layout, trainer.comm)
    assert sorted(tree) == sorted(state["params"])
    for k, v in tree.items():
        if k in STACKED:
            assert all(isinstance(e, LayerBlocks) for e in v)
            assert all(e.blocks is b for e, b in zip(v, state["params"][k], strict=True))
        else:
            assert all(isinstance(x, torch.Tensor) for x in tree_leaves(v))
    assert {"supers", "tail"} <= set(tree)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_dense_losses_bitwise_the_mesh_without_a_data_axis(remat):
    """The same global batch through (data 2, model 2) with FSDP storage
    and through (1, 2): the data ranks' rows fold into the same ring's
    batch and the gathers move values unchanged, so every loss is the
    same bit for bit."""
    over = dict(QWEN_OVER, remat=remat)
    _, fsdp = _port_run(_port_trainer(QWEN, over), 64)
    _, ring = _port_run(_port_trainer(QWEN, over, mesh=dict(sp_degree=2)), 64)
    assert fsdp == ring

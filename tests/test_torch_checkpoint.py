"""The port's checkpoint manager against the JAX manager and its tests
(``tests/test_substrate.py``'s checkpoint cases, merged into one
parametrised test), and the on-disk format both ways: a JAX checkpoint of
the JAX trainer state restores in the port to exactly ``from_jax_params``
of that state, a port checkpoint restores in the JAX manager, bf16 leaves
bit for bit either way.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.data.synthetic import SyntheticConfig as JDataCfg
from repro.data.synthetic import SyntheticDataset as JData
from repro.models import build_model as jbuild
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro.serving import kv_cache as jkv
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.trainer import Trainer, TrainerConfig

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
            vocab_size=97)


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(7, dtype=torch.int32)},
            "list": [torch.randn((3,), generator=g), torch.full((2, 2), seed, dtype=torch.int64)]}


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return torch.zeros_like(tree)


def _assert_trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# the manager's behaviour: the cases of test_substrate.py, one per parameter
# ---------------------------------------------------------------------------


def _roundtrip(mgr, d):
    t = _tree(0)
    mgr.save(5, t, extra={"data": {"step": 5}})
    assert mgr.latest_step() == 5
    template = _zeros(t)
    assert mgr.restore(5, template) is template  # filled in place
    _assert_trees_equal(template, t)
    assert mgr.manifest(5)["extra"]["data"]["step"] == 5
    assert mgr.manifest(5)["keys"] == ["a", "list/0", "list/1", "nested/b"]


def _keep_and_uncommitted_gc(mgr, d):
    for s in [1, 2, 3]:
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 3
    assert not os.path.exists(os.path.join(d, "step_000000001"))
    os.makedirs(os.path.join(d, "step_000000099"))  # a crashed save: no marker
    assert mgr.latest_step() == 3
    mgr._gc()
    assert not os.path.exists(os.path.join(d, "step_000000099"))


def _async(mgr, d):
    mgr.save(9, _tree(7), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 9
    _assert_trees_equal(mgr.restore(9, _zeros(_tree(7))), _tree(7))


def _strays_and_orphan_markers(mgr, d):
    open(os.path.join(d, "notes.txt"), "w").write("not a checkpoint")
    open(os.path.join(d, "weird.COMMITTED"), "w").close()
    os.makedirs(os.path.join(d, "step_nonnumeric"))
    open(os.path.join(d, "step_000000099.COMMITTED"), "w").close()  # orphaned marker
    assert mgr.latest_step() is None, "an orphan marker must never restore"
    mgr.save(1, _tree(1))
    assert mgr.latest_step() == 1
    assert not os.path.exists(os.path.join(d, "step_000000099.COMMITTED"))
    for stray in ("notes.txt", "weird.COMMITTED", "step_nonnumeric"):
        assert os.path.exists(os.path.join(d, stray)), stray
    mgr.save(2, _tree(2))  # keep=1: marker, then directory of step 1 go
    assert not os.path.exists(os.path.join(d, "step_000000001"))
    assert not os.path.exists(os.path.join(d, "step_000000001.COMMITTED"))
    assert mgr.latest_step() == 2


def _abandon(mgr, d):
    mgr._error = RuntimeError("crashed async writer")
    mgr.abandon()
    mgr.wait()  # the abandoned error must not resurface
    mgr.save(4, _tree(4))
    assert mgr.latest_step() == 4


def _bfloat16_bit_exact(mgr, d):
    t = {"kv": torch.randn((3, 5), generator=torch.Generator().manual_seed(2)).bfloat16()}
    mgr.save(1, t)
    assert mgr.manifest(1)["dtypes"] == {"kv": "bfloat16"}
    r = mgr.restore(1, _zeros(t))
    assert torch.equal(r["kv"].view(torch.int16), t["kv"].view(torch.int16))


CASES = {"roundtrip": (_roundtrip, 2), "keep_and_uncommitted_gc": (_keep_and_uncommitted_gc, 2),
         "async": (_async, 1), "strays_and_orphan_markers": (_strays_and_orphan_markers, 1),
         "abandon": (_abandon, 3), "bfloat16_bit_exact": (_bfloat16_bit_exact, 3)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_checkpoint_manager(case, tmp_path):
    fn, keep = CASES[case]
    fn(CheckpointManager(str(tmp_path), keep=keep), str(tmp_path))


def test_restore_refuses_missing_keys_and_uncommitted_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="missing keys"):
        mgr.restore(1, {"a": torch.ones(2), "b": torch.ones(1)})
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        mgr.restore(2, {"a": torch.ones(2)})


def test_async_save_is_immune_to_the_next_in_place_step(tmp_path):
    """The host copy is complete when ``save(blocking=False)`` returns: an
    in-place step taken right after it does not change the saved bytes
    (the writer thread is held until the step has run)."""
    import threading

    gate = threading.Event()
    real_savez = np.savez

    def held_savez(*args, **kw):
        gate.wait(10)
        return real_savez(*args, **kw)

    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "layers": [{"m": torch.ones(5)}, {"m": torch.full((5,), 2.0)}]}
    want = {"w": tree["w"].clone(), "layers": [{"m": x["m"].clone()} for x in tree["layers"]]}
    mgr = CheckpointManager(str(tmp_path))
    np.savez = held_savez
    try:
        mgr.save(1, tree, blocking=False)
        with torch.no_grad():  # the "step": AdamW-style in-place updates
            tree["w"].mul_(-3.0).add_(1.0)
            for x in tree["layers"]:
                x["m"].copy_(x["m"] * 7)
        gate.set()
        mgr.wait()
    finally:
        np.savez = real_savez
    _assert_trees_equal(mgr.restore(1, _zeros(tree)), want)
    assert mgr.manifest(1)["shapes"]["layers/m"] == [2, 5]  # stacked, as the JAX tree


# ---------------------------------------------------------------------------
# the format, both ways
# ---------------------------------------------------------------------------


def _jax_trained_state():
    """The JAX trainer's state after two steps (nonzero moments)."""
    jcfg = JARCHS["qwen3-1.7b"].reduced(**TINY)
    tcfg = TARCHS["qwen3-1.7b"].reduced(**TINY)
    trainer = JTrainer(jbuild(jcfg, JPctx(mesh=None, impl="xla")),
                       JTrainerConfig(lr=1e-3, warmup_steps=1, total_steps=2))
    state = trainer.init_state(jax.random.PRNGKey(3))
    data = JData(JDataCfg(vocab_size=97, seq_len=32, global_batch=2, seed=1))
    state, _ = trainer.run(state, data, log=lambda *a: None)
    return tcfg, state


def _port_state_of(tcfg, jstate):
    np_state = jax.tree.map(np.asarray, jstate)
    conv = lambda t: from_jax_params(tcfg, t, device="cpu", training=True)  # noqa: E731
    return {"params": conv(np_state["params"]),
            "opt": {"step": torch.from_numpy(np_state["opt"]["step"].copy()),
                    "m": conv(np_state["opt"]["m"]), "v": conv(np_state["opt"]["v"])},
            "step": torch.from_numpy(np_state["step"].copy())}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    tcfg, jstate = _jax_trained_state()
    JManager(str(tmp_path)).save(2, jstate, extra={"data": {"step": 2}})
    trainer = Trainer(tbuild(tcfg, TPctx(impl="torch", device="cpu")), TrainerConfig())
    template = trainer.init_state(0)
    got = CheckpointManager(str(tmp_path)).restore(2, template)
    want = _port_state_of(tcfg, jstate)
    assert int(got["step"]) == 2 and int(got["opt"]["step"]) == 2
    _assert_trees_equal(got, want)


def test_port_checkpoint_restores_in_jax(tmp_path):
    tcfg, jstate = _jax_trained_state()
    port_state = _port_state_of(tcfg, jstate)
    CheckpointManager(str(tmp_path)).save(2, port_state)
    jmgr = JManager(str(tmp_path))
    assert jmgr.latest_step() == 2
    got = jmgr.restore(2, jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bf16_serving_pool_both_ways(tmp_path):
    """A bf16 paged pool (the serving snapshot's device state) written by
    either manager reads back bit for bit in the other."""
    jstate = jkv.init_paged_cache(2, 2, 8, n_pages=6, page_size=4, max_batch=2, slot_pages=3,
                                  dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    jstate = dict(jstate, k=jnp.asarray(rng.standard_normal(jstate["k"].shape), jnp.bfloat16),
                  v=jnp.asarray(rng.standard_normal(jstate["v"].shape), jnp.bfloat16))
    bits = {n: np.asarray(jstate[n]).view(np.uint16) for n in ("k", "v")}
    JManager(str(tmp_path / "jax")).save(1, jstate)
    tstate = {n: torch.from_numpy(np.array(jstate[n], copy=True)) if n not in ("k", "v")
              else torch.zeros(jstate[n].shape, dtype=torch.bfloat16) for n in jstate}
    CheckpointManager(str(tmp_path / "jax")).restore(1, tstate)
    for n in ("k", "v"):
        np.testing.assert_array_equal(tstate[n].view(torch.int16).numpy().view(np.uint16),
                                      bits[n])
    CheckpointManager(str(tmp_path / "port")).save(1, tstate)
    got = JManager(str(tmp_path / "port")).restore(1, jax.tree.map(jnp.zeros_like, jstate))
    for n in jstate:
        np.testing.assert_array_equal(np.asarray(got[n]).view(np.uint16) if n in ("k", "v")
                                      else np.asarray(got[n]),
                                      bits[n] if n in ("k", "v") else np.asarray(jstate[n]))

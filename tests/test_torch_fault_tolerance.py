"""Checkpoint/restart training in the port: the Trainer's checkpoints, the
fault-tolerant runner (``test_substrate.py::test_fault_tolerant_restart_bitexact``
on the port, bitwise), the same run against the JAX fault-tolerant run from
the same parameters (losses and final parameters within the training
tolerances of ``test_torch_training.py``), and the train CLI's ``--ckpt``
and ``--fail-at`` on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.api import ParallelContext as JPctx
from repro.data import synthetic as jsyn
from repro.models import build_model as jbuild
from repro.runtime import fault_tolerance as jft
from repro.runtime import trainer as jtrainer
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core.api import ParallelContext as TPctx
from repro_torch.data import synthetic as tsyn
from repro_torch.models.convert import from_jax_params
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import trainer as ttrainer

TINY = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
            vocab_size=97)
DATA = dict(vocab_size=97, seq_len=32, global_batch=4, seed=2)
MODEL_TOL = dict(atol=2e-5, rtol=2e-4)  # test_torch_training.py's whole-model limits
QUIET = dict(log=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundle():
    return tbuild(TARCHS["qwen3-1.7b"].reduced(**TINY), TPctx(impl="torch", device="cpu"))


def _trainer(ckdir, hook=None, **kw):
    tcfg = ttrainer.TrainerConfig(lr=1e-3, warmup_steps=2, total_steps=20,
                                  checkpoint_every=10, checkpoint_dir=ckdir, **kw)
    return ttrainer.Trainer(_bundle(), tcfg, step_hook=hook)


def _data():
    return tsyn.SyntheticDataset(tsyn.SyntheticConfig(**DATA))


@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_fault_tolerant_restart_bitexact(async_checkpoint, tmp_path):
    """A failure at step 12 restores the step-10 checkpoint; the final state
    equals an uninterrupted run's bitwise (parameters, moments, step)."""
    t_ref = _trainer(str(tmp_path / "ref"), async_checkpoint=async_checkpoint)
    s_ref, h_ref = t_ref.run(t_ref.init_state(3), _data(), **QUIET)
    inj = tft.FailureInjector(at_steps=[12])
    t_ft = _trainer(str(tmp_path / "ft"), hook=inj, async_checkpoint=async_checkpoint)
    runner = tft.FaultTolerantRunner(t_ft, max_restarts=2, **QUIET)
    s_ft, h_ft = runner.run(3, _data())
    assert runner.restarts == 1 and inj.fired == {12}
    assert int(s_ft["step"]) == int(s_ref["step"]) == 20
    assert h_ft == h_ref[10:]  # the resumed run's losses
    for a, b in zip(tree_leaves(s_ref), tree_leaves(s_ft), strict=True):
        assert torch.equal(a, b)
    assert t_ft.ckpt.latest_step() == 20
    assert t_ft.ckpt.manifest(20)["extra"]["data"] == {"step": 20}


def test_ft_run_matches_the_jax_ft_run(tmp_path):
    """The same fault-tolerant run (failure at step 12, restore from 10) in
    both packages from the same parameters: losses and final parameters
    within the training tolerances."""
    jcfg = JARCHS["qwen3-1.7b"].reduced(**TINY)
    jtr = jtrainer.Trainer(jbuild(jcfg, JPctx(mesh=None, impl="xla")), jtrainer.TrainerConfig(
        lr=1e-3, warmup_steps=2, total_steps=20, checkpoint_every=10,
        checkpoint_dir=str(tmp_path / "jax"), async_checkpoint=False),
        step_hook=jft.FailureInjector([12]))
    jrunner = jft.FaultTolerantRunner(jtr, max_restarts=2, **QUIET)
    js, jh = jrunner.run(jax.random.PRNGKey(3), jsyn.SyntheticDataset(jsyn.SyntheticConfig(
        **DATA)))
    init = from_jax_params(_bundle().cfg, jax.tree.map(
        np.asarray, jtr.init_state(jax.random.PRNGKey(3))["params"]), device="cpu",
        training=True)
    ttr = _trainer(str(tmp_path / "port"), hook=tft.FailureInjector([12]))
    ttr.init_state = lambda seed: ttr.state_from_params(tree_map(torch.clone, init))
    trunner = tft.FaultTolerantRunner(ttr, max_restarts=2, **QUIET)
    ts, th = trunner.run(3, _data())
    assert trunner.restarts == jrunner.restarts == 1
    np.testing.assert_allclose(th, jh, **MODEL_TOL)
    want = from_jax_params(ttr.bundle.cfg, jax.tree.map(np.asarray, js["params"]), device="cpu",
                           training=True)
    for a, b in zip(tree_leaves(ts["params"]), tree_leaves(want), strict=True):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), **MODEL_TOL)


def test_runner_restarts_from_scratch_then_gives_up(tmp_path):
    """A failure before the first checkpoint restarts from step 0 (the data
    rewound); failures past ``max_restarts`` propagate."""
    t_ref = _trainer(None)
    s_ref, _ = t_ref.run(t_ref.init_state(1), _data(), steps=6, **QUIET)
    t = _trainer(str(tmp_path / "a"), hook=tft.FailureInjector([3]))
    runner = tft.FaultTolerantRunner(t, max_restarts=1, **QUIET)
    s, h = runner.run(1, _data(), steps=6)
    assert runner.restarts == 1 and len(h) == 6
    for a, b in zip(tree_leaves(s_ref), tree_leaves(s), strict=True):
        assert torch.equal(a, b)

    class Always:
        def __call__(self, step):
            if step == 2:
                raise tft.SimulatedFailure("again")

    t = _trainer(str(tmp_path / "b"), hook=Always())
    with pytest.raises(tft.SimulatedFailure, match="again"):
        tft.FaultTolerantRunner(t, max_restarts=2, **QUIET).run(1, _data(), steps=6)
    with pytest.raises(AssertionError, match="checkpoint dir"):
        tft.FaultTolerantRunner(_trainer(None), **QUIET).run(1, _data())


def test_warm_start_resumes_a_killed_job(tmp_path):
    """A new runner over a directory that already holds a committed
    checkpoint resumes from it (a job restart), bitwise."""
    t_ref = _trainer(None)
    s_ref, _ = t_ref.run(t_ref.init_state(4), _data(), **QUIET)
    t1 = _trainer(str(tmp_path))
    t1.run(t1.init_state(4), _data(), steps=10, **QUIET)
    logs = []
    t2 = _trainer(str(tmp_path))
    s, h = tft.FaultTolerantRunner(t2, log=logs.append).run(4, _data())
    assert logs == ["[ft] resumed from step 10"] and len(h) == 10
    for a, b in zip(tree_leaves(s_ref), tree_leaves(s), strict=True):
        assert torch.equal(a, b)


def test_train_cli_checkpoint_and_fail_at_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    args = ["--reduced", "--device", "cpu", "--steps", "5", "--batch", "2", "--seq", "64",
            "--ckpt-every", "2"]
    ref = main(args + ["--ckpt", str(tmp_path / "ref")])
    capsys.readouterr()
    hist = main(args + ["--ckpt", str(tmp_path / "ft"), "--fail-at", "3"])
    out = capsys.readouterr().out
    assert "1 restart(s)" in out and "final step 5" in out and "latest step 4" in out
    assert hist == ref[2:]  # resumed at step 2: the losses of steps 2-4, bitwise

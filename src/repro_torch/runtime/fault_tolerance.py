"""Fault-tolerant training runner: checkpoint/restart with bounded retries
(port of ``repro.runtime.fault_tolerance``).

``FaultTolerantRunner`` wraps a Trainer run; any exception (an injected
node failure, a preemption signal, data corruption) triggers a restore from
the latest committed checkpoint and a resume, up to ``max_restarts``.  With
deterministic data and a deterministic step the restored run ends bitwise
equal to an uninterrupted one.  ``FailureInjector`` raises at configured
steps: the test double for a dying host.
"""

from __future__ import annotations

__all__ = ["FailureInjector", "FaultTolerantRunner", "SimulatedFailure"]


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    """Raises SimulatedFailure the first time each configured step starts."""

    def __init__(self, at_steps=()):
        self.at_steps = set(at_steps)
        self.fired = set()

    def __call__(self, step: int):
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class FaultTolerantRunner:
    def __init__(self, trainer, *, max_restarts: int = 3, log=print):
        self.trainer = trainer
        self.max_restarts = max_restarts
        self.log = log
        self.restarts = 0

    def run(self, seed: int, data_iter, *, steps=None):
        """Run to completion from ``trainer.init_state(seed)``, restoring from
        checkpoints on failure."""
        assert self.trainer.ckpt is not None, "fault tolerance needs a checkpoint dir"
        state = self.trainer.init_state(seed)
        # warm start if a committed checkpoint already exists (job restart)
        restored = self.trainer.restore_latest(state, data_iter)
        if restored is not None:
            state = restored
            self.log(f"[ft] resumed from step {int(state['step'])}")

        history = []
        while True:
            try:
                state, h = self.trainer.run(state, data_iter, steps=steps)
                history.extend(h)
                return state, history
            except Exception as e:  # noqa: BLE001
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    self.log(f"[ft] giving up after {self.restarts - 1} restarts")
                    raise
                self.log(f"[ft] failure: {e!r}, restoring the latest checkpoint "
                         f"(restart {self.restarts}/{self.max_restarts})")
            # Out of the except block, the failed run's frames (and the
            # device tensors they held) are gone; drop the failed state too
            # before a fresh one is built (at qwen3-1.7b each is 20.6 GB).
            state = None
            self.trainer.ckpt.abandon()  # a crashed async save is void
            fresh = self.trainer.init_state(seed)
            restored = self.trainer.restore_latest(fresh, data_iter)
            if restored is None:
                state = fresh
                if hasattr(data_iter, "load_state_dict"):
                    data_iter.load_state_dict({"step": 0})
                self.log("[ft] no checkpoint yet: restarting from scratch")
            else:
                state = restored
                self.log(f"[ft] resumed from step {int(state['step'])}")

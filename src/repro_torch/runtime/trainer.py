"""Training driver: step, microbatch accumulation, metrics, checkpoints
(port of ``repro.runtime.trainer``).

The step is eager PyTorch: the loss and its gradients through the bundle
(kernel A forward, B1/B2 backward on the card), then AdamW in place.  The
loop synchronises the device once per step, as ``block_until_ready`` does
in the JAX loop, so the step time it logs is the device's.  With
``checkpoint_dir`` the loop saves the state (and the data iterator's
position) every ``checkpoint_every`` steps through
:class:`~repro_torch.checkpoint.manager.CheckpointManager`, by default
asynchronously: the host copy is taken before the next in-place step.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.train_step import value_and_grad
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, tree_leaves, tree_map
from repro_torch.runtime.straggler import StragglerDetector

__all__ = ["TrainerConfig", "Trainer", "cosine_lr", "batch_to_device", "n_params"]


@dataclass
class TrainerConfig:
    lr: float = 3e-4
    warmup_steps: int = 20
    total_steps: int = 100
    microbatches: int = 1  # gradient accumulation factor
    checkpoint_every: int = 50
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    opt: AdamWConfig = field(default_factory=AdamWConfig)


def cosine_lr(cfg: TrainerConfig, step):
    """Linear warmup then cosine decay, in float32 from an int32 ``step``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def batch_to_device(batch, device):
    """A numpy batch (``data.synthetic``) as tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, bundle, tcfg: TrainerConfig, *, step_hook=None):
        self.bundle = bundle
        self.cfg = tcfg
        self.device = torch.device(bundle.pctx.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer on device 'cuda' needs a CUDA device and none is available; build "
                "the bundle with ParallelContext(device='cpu') to train on the CPU")
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
                     if tcfg.checkpoint_dir else None)
        self.straggler = StragglerDetector()
        self.step_hook = step_hook  # called as (step,) before each step
        self.step_seconds: list[float] = []  # wall time of each step run() took

    # ------------------------------------------------------------ state

    def init_state(self, seed: int):
        """Seeded random parameters in the training layout (every leaf in
        ``cfg.param_dtype``), zero AdamW moments, step 0."""
        return self.state_from_params(self.bundle.init(seed, training=True))

    def state_from_params(self, params):
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32, device=self.device)}

    # ------------------------------------------------------------- step

    def _step(self, state, batch):
        cfg = self.cfg
        if cfg.microbatches > 1:
            n = cfg.microbatches
            mbs = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
                   for i in range(n)]
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                            state["params"])
            lsum = torch.zeros((), dtype=torch.float32, device=self.device)
            for mb in mbs:
                (loss, _), grads = value_and_grad(self.bundle.loss, state["params"], mb)
                gsum = tree_map(torch.add, gsum, grads)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / n, gsum)
            loss = lsum / n
            metrics = {}
        else:
            (loss, metrics), grads = value_and_grad(self.bundle.loss, state["params"], batch)

        lr = cosine_lr(cfg, state["step"])
        params, opt, om = adamw_update(grads, state["opt"], state["params"], lr=lr, cfg=cfg.opt)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "lr": lr, **metrics, **om}

    # ------------------------------------------------------------- loop

    def run(self, state, data_iter, *, steps=None, log_every: int = 10, log=print):
        steps = steps if steps is not None else self.cfg.total_steps
        history = []
        start_step = int(state["step"])
        for i in range(start_step, steps):
            if self.step_hook is not None:
                self.step_hook(i)
            batch = batch_to_device(next(data_iter), self.device)
            t0 = time.perf_counter()
            state, metrics = self._step(state, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.step_seconds.append(dt)
            flag = self.straggler.record(i, dt)
            if flag:
                log(f"[straggler] step {i}: {dt*1e3:.1f} ms ({flag})")
            if i % log_every == 0 or i == steps - 1:
                router = (f" (ce {float(metrics['ce_loss']):.4f} aux "
                          f"{float(metrics['aux_loss']):.4f})" if self.bundle.cfg.n_experts
                          else "")
                log(f"step {i:5d} loss {float(metrics['loss']):.4f}{router} "
                    f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f} ms")
            history.append(float(metrics["loss"]))
            if self.ckpt and (i + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(i + 1, state,
                               extra={"data": getattr(data_iter, "state_dict", dict)()},
                               blocking=not self.cfg.async_checkpoint)
        if self.ckpt:
            self.ckpt.wait()
        return state, history

    # ------------------------------------------------------- restore

    def restore_latest(self, template_state, data_iter=None):
        """The latest committed checkpoint restored into ``template_state``
        (in place), and the data iterator rewound to its position; ``None``
        without a checkpoint."""
        if self.ckpt is None:
            return None
        step = self.ckpt.latest_step()
        if step is None:
            return None
        state = self.ckpt.restore(step, template_state)
        if data_iter is not None and hasattr(data_iter, "load_state_dict"):
            data_iter.load_state_dict(self.ckpt.manifest(step)["extra"]["data"])
        return state


def n_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))

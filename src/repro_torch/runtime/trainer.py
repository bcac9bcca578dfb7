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

**On a mesh** (``bundle.pctx.mesh``: a data axis, ``--data-degree`` > 1)
the state holds FSDP blocks (``repro_torch.sharding``) of the parameters
and of both AdamW moments, laid out by the rules on the mesh.  A step
gathers the parameters just in time (``sharding.gather_step_params``): the
leaves outside the layer stacks at the start of the loss, each layer inside
its layer loop's remat region, again when the backward recomputes it; each
gather is a differentiable all-gather whose backward reduce-scatters and
all-reduces the gradients.  The step then updates the blocks in place.
The loss is the token-weighted mean over the global batch, ``sum(loss_r *
tokens_r) / sum(tokens_r)`` over every rank, what the reference's SPMD loss
is: on the virtual mesh the model sees the whole batch, so its loss is that
mean already; on a process group each rank backpropagates ``loss_r * tokens_r / sum(tokens)``, and the
gradient's reduce-scatter sums the ranks.  :func:`batch_to_device` cuts a
process's (data, sequence) block of the numpy batch.  Checkpoints of the
virtual mesh hold full arrays; a process group's hold each rank's blocks
and the mesh and specs in the manifest, and restore onto any mesh.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.train_step import step_loss, value_and_grad
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


def batch_to_device(batch, device, pctx=None):
    """A numpy batch (``data.synthetic``) as tensors on ``device``: on a
    process group of a mesh (``pctx``), this rank's (data, sequence) block
    by ``sharding.batch_shardings``; otherwise the whole batch."""
    storage = getattr(pctx, "storage", None)
    if storage is not None and not storage.folded:
        from repro_torch.sharding import batch_block

        batch = batch_block(batch, pctx, storage.rank)
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
        pctx = bundle.pctx
        self.comm = pctx.storage  # the mesh's FSDP collectives; None: no mesh
        self.layout = None  # the state's FSDP layout, set when the state is built
        group = None if self.comm is None or self.comm.folded else self.comm.group
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints,
                                       group=group)
                     if tcfg.checkpoint_dir else None)
        self.straggler = StragglerDetector()
        self.step_hook = step_hook  # called as (step,) before each step
        self.step_seconds: list[float] = []  # wall time of each step run() took

    # ------------------------------------------------------------ state

    def init_state(self, seed: int):
        """Seeded random parameters in the training layout (every leaf in
        ``cfg.param_dtype``), zero AdamW moments, step 0; on a mesh, this
        process's FSDP blocks of them."""
        return self.state_from_params(self.bundle.init(seed, training=True))

    def state_from_params(self, params):
        """The state of full parameters ``params`` (cut to this process's
        blocks on a mesh)."""
        if self.comm is not None:
            from repro_torch.sharding import layout_for, shard_tree

            layout = layout_for(params, self.bundle.pctx.mesh, rank=self.comm.rank)
            params = shard_tree(params, layout)
            meta = layout.meta
            self.layout = layout_for(
                {"params": meta, "opt": {"m": meta, "step": _META_STEP, "v": meta},
                 "step": _META_STEP}, layout.mesh, rank=self.comm.rank)
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32, device=self.device)}

    @property
    def params_layout(self):
        """The parameters' part of :attr:`layout`."""
        from repro_torch.sharding import Layout

        lay = self.layout
        return Layout(lay.mesh, lay.specs["params"], lay.meta["params"], lay.rank)

    def full_params(self, state):
        """The full parameters of ``state`` (gathered on a process group,
        collective; assembled on the virtual mesh)."""
        if self.comm is None:
            return state["params"]
        from repro_torch.sharding import unshard_tree

        return unshard_tree(state["params"], self.params_layout, self.comm)

    # ------------------------------------------------------------- step

    def _loss(self, params, batch):
        """The loss to differentiate and its metrics
        (``launch.train_step.step_loss``: on a mesh the blocks are gathered
        just in time, and on a process group each rank's loss is weighted by
        its share of the global batch's tokens); ``metrics["loss"]`` is the
        global batch's loss."""
        return step_loss(self.bundle, self.params_layout if self.comm is not None else None)(
            params, batch)

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
                (_, m), grads = value_and_grad(self._loss, state["params"], mb)
                gsum = tree_map(torch.add, gsum, grads)
                lsum = lsum + m["loss"]
            grads = tree_map(lambda g: g / n, gsum)
            loss = lsum / n
            metrics = {}
        else:
            (_, metrics), grads = value_and_grad(self._loss, state["params"], batch)
            loss = metrics.pop("loss")

        lr = cosine_lr(cfg, state["step"])
        layout = self.params_layout if self.comm is not None else None
        params, opt, om = adamw_update(grads, state["opt"], state["params"], lr=lr, cfg=cfg.opt,
                                       layout=layout, comm=self.comm)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "lr": lr, **metrics, **om}

    # ------------------------------------------------------------- loop

    def run(self, state, data_iter, *, steps=None, log_every: int = 10, log=print):
        steps = steps if steps is not None else self.cfg.total_steps
        history = []
        start_step = int(state["step"])
        group_save = self.comm is not None and not self.comm.folded
        for i in range(start_step, steps):
            if self.step_hook is not None:
                self.step_hook(i)
            batch = batch_to_device(next(data_iter), self.device, self.bundle.pctx)
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
                               blocking=not self.cfg.async_checkpoint or group_save,
                               layout=self.layout)
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
        state = self.ckpt.restore(step, template_state, layout=self.layout)
        if data_iter is not None and hasattr(data_iter, "load_state_dict"):
            data_iter.load_state_dict(self.ckpt.manifest(step)["extra"]["data"])
        return state


_META_STEP = torch.empty((), dtype=torch.int32, device="meta")


def n_params(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))

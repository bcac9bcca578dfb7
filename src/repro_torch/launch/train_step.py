"""Train-step builder (port of ``repro.launch.train_step``).

:func:`value_and_grad` is the counterpart of ``jax.value_and_grad(...,
has_aux=True)`` on a parameter tree: it marks the leaves as requiring grad,
runs the loss with grad enabled and returns the gradients as a tree of the
same structure.
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, tree_leaves,
                                     tree_map)

__all__ = ["make_opt_init", "make_train_step", "step_loss", "value_and_grad"]


def make_opt_init():
    """The optimizer-state initialiser that :func:`make_train_step`'s step
    updates: ``adamw_init(params)``."""
    return adamw_init


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)``; the loss
    and metrics come back detached, unused leaves get zero gradients."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _: next(grads), params)


def step_loss(bundle, layout=None):
    """``loss_fn(params, batch) -> (loss, metrics)``, what a step
    differentiates.  ``layout``: the parameters' FSDP layout
    (``sharding.Layout``) when the bundle's context stores them over a mesh;
    the step then gathers the blocks just in time
    (``sharding.gather_step_params``), and on a process group each rank's
    loss is weighted by its share of the global batch's tokens, so that the
    gradients' reduce-scatter sums the global mean's (``runtime.trainer``).
    ``metrics["loss"]`` is the global batch's loss."""
    comm = bundle.pctx.storage

    def loss_fn(params, batch):
        if layout is None:
            loss, metrics = bundle.loss(params, batch)
            return loss, {**metrics, "loss": loss.detach()}
        from repro_torch.sharding import gather_step_params

        loss, metrics = bundle.loss(gather_step_params(params, layout, comm), batch)
        if comm.folded:
            return loss, {**metrics, "loss": loss.detach()}
        tokens = metrics["tokens"].detach().float()
        total = comm.world_sum(tokens)
        weighted = loss * (tokens / total)
        return weighted, {**metrics, "loss": comm.world_sum(weighted.detach())}

    return loss_fn


def make_train_step(bundle, *, lr=3e-4, opt_cfg: AdamWConfig = AdamWConfig(), layout=None):
    """``train_step(params, opt_state, batch) -> (params, opt, metrics)``:
    gradients of :func:`step_loss` and one AdamW step (in place, see
    ``optim.adamw``).  ``layout``: the parameters' FSDP layout when they
    are stored as blocks over the bundle's mesh (the moments mirror them)."""
    loss_fn = step_loss(bundle, layout)
    comm = bundle.pctx.storage if layout is not None else None

    def train_step(params, opt_state, batch):
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        new_params, new_opt, opt_metrics = adamw_update(grads, opt_state, params, lr=lr,
                                                        cfg=opt_cfg, layout=layout, comm=comm)
        return new_params, new_opt, {**metrics, **opt_metrics}

    return train_step

"""Train-step builder (port of ``repro.launch.train_step``).

:func:`value_and_grad` is the counterpart of ``jax.value_and_grad(...,
has_aux=True)`` on a parameter tree: it marks the leaves as requiring grad,
runs the loss with grad enabled and returns the gradients as a tree of the
same structure.
"""

from __future__ import annotations

import torch

from repro_torch.optim.adamw import AdamWConfig, adamw_update, tree_leaves, tree_map

__all__ = ["make_train_step", "value_and_grad"]


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


def make_train_step(bundle, *, lr=3e-4, opt_cfg: AdamWConfig = AdamWConfig()):
    """``train_step(params, opt_state, batch) -> (params, opt, metrics)``:
    gradients of the bundle loss and one AdamW step (in place, see
    ``optim.adamw``)."""

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(bundle.loss, params, batch)
        new_params, new_opt, opt_metrics = adamw_update(grads, opt_state, params, lr=lr,
                                                        cfg=opt_cfg)
        return new_params, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step

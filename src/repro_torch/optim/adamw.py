"""AdamW with global-norm clipping (port of ``repro.optim.adamw``).

Parameters, gradients and the moments are trees: nested dicts and lists of
tensors, as ``models.transformer.init_lm`` builds them.  The arithmetic is
the JAX code's, leaf by leaf: float32 ``m``/``v``, bias correction from a
float32 step, the global-norm clip, weight decay on every leaf.

Unlike the JAX function, :func:`adamw_update` updates ``params`` and the
moments **in place** (under ``torch.no_grad``) and returns them: at
qwen3-1.7b a second copy of the float32 parameters and moments would cost
another 20 GB of device memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "tree_leaves",
           "tree_map"]


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts and lists, dict keys in sorted order (the
    order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``,
    visited in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step; ``lr`` is a float or a scalar tensor (a schedule value).

    Updates ``params`` and ``state`` in place and returns ``(params, state,
    metrics)``.
    """
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), step_f)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), step_f)

    def upd(p, g, m, v):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"])):
        upd(p, g, m, v)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "clip_scale": scale}

"""Online-softmax partial merging: the paper's ``Update()`` (port of
``repro.core.merge``).

A partial is ``(out (..., S, H, D), lse (..., S, H) float32)``; the empty
partial ``(0, -inf)`` is the merge identity.  The merge is written in the
-inf-safe and gradient-safe form of the reference: on an empty lane the
input of ``exp`` is replaced by ``-inf`` and that of ``log`` by a constant
before the transcendental is applied, so values and gradients stay finite.
"""

from __future__ import annotations

import torch

__all__ = ["empty_partial", "merge_partials", "merge_partials_paper_form", "merge_many",
           "finalize"]


def empty_partial(shape_out, dtype=torch.float32, device=None):
    """Identity element for the merge: ``out = 0``, ``lse = -inf``."""
    out = torch.zeros(shape_out, dtype=dtype, device=device)
    lse = torch.full(tuple(shape_out[:-1]), -torch.inf, dtype=torch.float32, device=device)
    return out, lse


def merge_partials(out_a, lse_a, out_b, lse_b):
    """Combine two attention partials; accumulates in float32, returns
    ``out_a.dtype``.  Stable when either or both sides are empty."""
    lse_a = lse_a.float()
    lse_b = lse_b.float()
    neg_a = torch.isneginf(lse_a)
    neg_b = torch.isneginf(lse_b)
    both_empty = neg_a & neg_b
    m_safe = torch.where(both_empty, 0.0, torch.maximum(lse_a, lse_b))
    # The double where of the reference: an empty lane goes through
    # exp(-inf) = 0, never through exp(0 - m_safe), which overflows for
    # m_safe below about -88.7 and turns the backward's 0 * inf into NaN.
    ea = torch.exp(torch.where(neg_a, -torch.inf, torch.where(neg_a, 0.0, lse_a) - m_safe))
    eb = torch.exp(torch.where(neg_b, -torch.inf, torch.where(neg_b, 0.0, lse_b) - m_safe))
    denom_safe = torch.where(both_empty, 1.0, ea + eb)
    lse = torch.where(both_empty, -torch.inf, m_safe + torch.log(denom_safe))
    w_a = (ea / denom_safe)[..., None]
    w_b = (eb / denom_safe)[..., None]
    out32 = w_a * out_a.float() + w_b * out_b.float()
    return out32.to(out_a.dtype), lse


def merge_partials_paper_form(out, lse, block_out, block_lse):
    """The paper's update equations (§3.1), for fidelity testing:

        out = out - sigmoid(block_lse - lse) * (out - block_out)
        lse = lse - log(sigmoid(lse - block_lse))

    Not -inf-safe (the paper assumes non-degenerate partials); the oracle of
    :func:`merge_partials` on finite inputs."""
    lse = lse.float()
    block_lse = block_lse.float()
    sig = torch.sigmoid(block_lse - lse)[..., None]
    new_out = out - sig * (out - block_out)
    new_lse = lse - torch.nn.functional.logsigmoid(lse - block_lse)
    return new_out.to(out.dtype), new_lse


def merge_many(partials):
    """Fold an iterable of ``(out, lse)`` partials left to right."""
    partials = list(partials)
    out, lse = partials[0]
    for o, l in partials[1:]:
        out, lse = merge_partials(out, lse, o, l)
    return out, lse


def finalize(out, lse):
    """Zero the rows that attended to nothing (``lse == -inf``)."""
    return torch.where(torch.isneginf(lse)[..., None], 0.0, out).to(out.dtype), lse

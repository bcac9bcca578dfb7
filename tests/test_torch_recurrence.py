"""The port's sequence-parallel scan (``repro_torch.core.recurrence``,
``ParallelContext.plan_scan``, ``sp_scan``) against the JAX package's
``repro.core.recurrence`` and a sequential numpy oracle, on the same numpy
inputs.

* ``local_linear_recurrence`` (h, A_last, h_last, with and without ``h0``)
  over the shapes of ``tests/test_properties.py``'s property;
* ``sp_scan`` on the virtual ring at P = 2, 4 and 8 and on 2 x 2 pods,
  against ``check_scan``/``check_scan_hybrid``'s sequential oracle (the
  reference's seeds 17 and 19, atol/rtol 1e-5), with a zigzag context (the
  sequence is sharded contiguously whatever the layout), along another axis
  and at ring sizes that are no power of two;
* the gradients of ``sp_scan`` at P = 4 (and 2 x 2 pods) against SP 1's
  and against ``jax.grad`` of the JAX local scan;
* the ranks' exclusive composition, and the bytes the ring is handed
  against ``scan_comm_bytes``'s closed form, forward and backward.

The doubling rounds in another order than ``lax.associative_scan``'s tree
and than the sequential loop: float32 results are held to atol/rtol 1e-5.
The process-group form runs in ``test_torch_mamba.py``'s gloo spawn.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import recurrence as jrec
from repro_torch.core import recurrence as trec
from repro_torch.core.api import ParallelContext, sp_scan
from repro_torch.core.collectives import VirtualRing, fold_ranks

TOL = dict(atol=1e-5, rtol=1e-5)


def _sequential(a, b, h0=None, axis=1):
    """``h`` of ``h_t = a_t h_{t-1} + b_t`` by a loop over time (numpy)."""
    a, b = np.moveaxis(a, axis, 1), np.moveaxis(b, axis, 1)
    h = np.zeros_like(b[:, 0]) if h0 is None else h0.copy()
    outs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        outs.append(h.copy())
    return np.moveaxis(np.stack(outs, 1), 1, axis)


def _scan_inputs(seed, B, S, D, lo=0.5):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, 0.99, (B, S, D)).astype(np.float32)
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("S", [1, 3, 8, 17, 32])
def test_local_linear_recurrence_matches_jax_and_sequential(S, D, with_h0):
    rng = np.random.default_rng(1000 * S + 10 * D + with_h0)
    a = rng.uniform(-1.0, 1.0, (2, S, D)).astype(np.float32)
    b = rng.standard_normal((2, S, D)).astype(np.float32)
    h0 = rng.standard_normal((2, D)).astype(np.float32) if with_h0 else None
    th, (tA, tl) = trec.local_linear_recurrence(
        torch.from_numpy(a), torch.from_numpy(b),
        h0=None if h0 is None else torch.from_numpy(h0))
    jh, (jA, jl) = jrec.local_linear_recurrence(
        jnp.asarray(a), jnp.asarray(b), h0=None if h0 is None else jnp.asarray(h0))
    ref = _sequential(a, b, h0)
    np.testing.assert_allclose(th.numpy(), ref, **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tl.numpy(), ref[:, -1], **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tA.numpy(), np.prod(a, axis=1), **TOL)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), **TOL)


def test_inclusive_scan_is_a_doubling_not_a_loop_over_time():
    """ceil(log2 S) rounds: a scan of 33 steps concatenates 6 times per
    output, never once per step."""
    a, b = (torch.from_numpy(x) for x in _scan_inputs(3, 2, 33, 4))
    calls = []
    real_cat = torch.cat

    def counting_cat(*args, **kw):
        calls.append(1)
        return real_cat(*args, **kw)

    torch.cat = counting_cat
    try:
        trec.inclusive_scan(a, b)
    finally:
        torch.cat = real_cat
    assert len(calls) == 2 * math.ceil(math.log2(33))


@pytest.mark.parametrize("P", [2, 4, 8])
def test_sp_scan_matches_sequential(P):
    """``check_scan``'s case (seed 17, B 2, S 64, state 8) at P ranks."""
    a, b = _scan_inputs(17, 2, 64, 8)
    h = sp_scan(torch.from_numpy(a), torch.from_numpy(b),
                pctx=ParallelContext(device="cpu", sp_degree=P, layout="contig"))
    np.testing.assert_allclose(h.numpy(), _sequential(a, b), **TOL)


def test_sp_scan_pods_match_sequential():
    """``check_scan_hybrid``'s case (seed 19, B 2, S 32, state 4) on 2 pods
    of 2 ranks: pod-major rank order."""
    a, b = _scan_inputs(19, 2, 32, 4)
    pctx = ParallelContext(device="cpu", sp_degree=4, pods=2, layout="contig")
    h = sp_scan(torch.from_numpy(a), torch.from_numpy(b), pctx=pctx)
    np.testing.assert_allclose(h.numpy(), _sequential(a, b), **TOL)


@pytest.mark.parametrize("P", [3, 6])
def test_sp_scan_ring_sizes_not_a_power_of_two(P):
    a, b = _scan_inputs(P, 2, 48, 4)
    h = sp_scan(torch.from_numpy(a), torch.from_numpy(b),
                pctx=ParallelContext(device="cpu", sp_degree=P))
    np.testing.assert_allclose(h.numpy(), _sequential(a, b), **TOL)


def test_sp_scan_zigzag_context_shards_contiguously():
    """A zigzag context gives the same ``h``: a recurrence runs in time
    order, so the scan shards contiguously whatever the layout."""
    a, b = _scan_inputs(17, 2, 64, 8)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    contig = sp_scan(at, bt, pctx=ParallelContext(device="cpu", sp_degree=4, layout="contig"))
    zz = sp_scan(at, bt, pctx=ParallelContext(device="cpu", sp_degree=4, layout="zigzag"))
    assert torch.equal(zz, contig)
    np.testing.assert_allclose(zz.numpy(), _sequential(a, b), **TOL)


def test_sp_scan_along_another_axis():
    """Time on axis 2 of ``(B, D, S)``: the plan folds that axis."""
    a, b = _scan_inputs(5, 2, 32, 3)
    at, bt = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))) for x in (a, b))
    pctx = ParallelContext(device="cpu", sp_degree=4)
    h = sp_scan(at, bt, pctx=pctx, axis=2)
    np.testing.assert_allclose(h.numpy(), _sequential(a, b).transpose(0, 2, 1), **TOL)
    assert pctx.plan_scan(ndim=3, axis=2) is pctx.plan_scan(ndim=3, axis=2)
    with pytest.raises(ValueError, match="non-batch dim"):
        pctx.plan_scan(ndim=3, axis=0)


def test_sp_scan_at_sp1_is_the_jax_local_scan():
    a, b = _scan_inputs(7, 2, 40, 5)
    h = sp_scan(torch.from_numpy(a), torch.from_numpy(b), pctx=ParallelContext(device="cpu"))
    jh, _ = jrec.local_linear_recurrence(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("pods", [1, 2])
def test_sp_scan_gradients_match_sp1_and_jax(pods):
    a, b = _scan_inputs(23, 2, 64, 8)
    w = np.random.default_rng(24).standard_normal(a.shape).astype(np.float32)

    def grads(pctx):
        at = torch.from_numpy(a).requires_grad_(True)
        bt = torch.from_numpy(b).requires_grad_(True)
        h = sp_scan(at, bt, pctx=pctx)
        return [g.numpy() for g in torch.autograd.grad((h * torch.from_numpy(w)).sum(),
                                                       [at, bt])]

    g4 = grads(ParallelContext(device="cpu", sp_degree=4, pods=pods))
    g1 = grads(ParallelContext(device="cpu"))
    jg = jax.grad(lambda a, b: (jrec.local_linear_recurrence(a, b)[0] * w).sum(),
                  argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    for got, sp1, want in zip(g4, g1, jg):
        np.testing.assert_allclose(got, sp1, **TOL)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("P", [2, 4, 5, 8])
def test_device_exclusive_scan_composes_the_earlier_ranks(P):
    """Rank r receives ranks 0..r-1 composed in order (the identity on
    rank 0), on the virtual ring's folded summaries."""
    rng = np.random.default_rng(P)
    B, D = 2, 3
    A = rng.uniform(0.5, 1.0, (P, B, D)).astype(np.float32)
    h = rng.standard_normal((P, B, D)).astype(np.float32)
    ring = VirtualRing(P, "cpu")
    gA, gh = trec.device_exclusive_scan(
        (torch.from_numpy(A.reshape(P * B, D)), torch.from_numpy(h.reshape(P * B, D))), ring)
    wantA, wanth = np.ones((B, D), np.float32), np.zeros((B, D), np.float32)
    for r in range(P):
        np.testing.assert_allclose(gA.numpy()[r * B:(r + 1) * B], wantA, **TOL)
        np.testing.assert_allclose(gh.numpy()[r * B:(r + 1) * B], wanth, **TOL)
        wantA, wanth = wantA * A[r], A[r] * wanth + h[r]


@pytest.mark.parametrize("P", [2, 3, 4, 8])
def test_scan_bytes_match_the_closed_form(P):
    """The ring is handed ``ceil(log2 P) + 1`` shifts of the two summary
    tensors a rank, charged at their distance in hops; the backward hands
    over the transposes, the same bytes the other way."""
    B, S, D = 2, 8 * P, 4
    a, b = (torch.from_numpy(x).requires_grad_(True) for x in _scan_inputs(P, B, S, D))
    pctx = ParallelContext(device="cpu", sp_degree=P)
    h = sp_scan(a, b, pctx=pctx)
    want = trec.scan_comm_bytes(P, B * D * 4)
    assert want["rounds"] == math.ceil(math.log2(P)) + 1
    assert want["messages"]["fwd"] == want["rounds"] * 2 * B * D * 4
    assert pctx.ring.link_bytes == {"fwd": want["link_bytes"]["fwd"], "bwd": 0.0}
    h.sum().backward()
    assert pctx.ring.link_bytes == want["link_bytes"]
    assert pctx.ring.position_bytes == {"fwd": 0.0, "bwd": 0.0}


@pytest.mark.parametrize("P", [2, 4, 8])
def test_scan_messages_match_the_closed_form(P):
    """Counting each shift once (a transport's post, whatever its
    distance): ``ceil(log2 P) + 1`` rounds of two tensors forward, the
    transposes of those that reach the loss backward."""
    B, S, D = 2, 8 * P, 4
    a, b = (torch.from_numpy(x).requires_grad_(True) for x in _scan_inputs(P, B, S, D))
    pctx = ParallelContext(device="cpu", sp_degree=P)
    ring, sent = pctx.ring, {"fwd": 0, "bwd": 0}
    real_move = ring._move

    def counting_move(x, shift):
        sent["fwd" if shift > 0 else "bwd"] += x.numel() * x.element_size() // P
        return real_move(x, shift)

    ring._move = counting_move
    sp_scan(a, b, pctx=pctx).sum().backward()
    assert sent == trec.scan_comm_bytes(P, B * D * 4)["messages"]


def test_chunked_linear_recurrence_on_folded_shards():
    """The per-rank function on folded shards equals the global scan's
    shards (the form ``models.mamba`` and the plan call)."""
    P = 4
    a, b = _scan_inputs(31, 2, 32, 4)
    ring = VirtualRing(P, "cpu")
    h = trec.chunked_linear_recurrence(fold_ranks(torch.from_numpy(a), P),
                                       fold_ranks(torch.from_numpy(b), P), ring=ring)
    np.testing.assert_allclose(h.numpy(), fold_ranks(torch.from_numpy(_sequential(a, b)),
                                                     P).numpy(), **TOL)

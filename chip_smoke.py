#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. toolchain: torch, CUDA, nvcc and the card's name and power limit;
  2. build every kernel in ``src/repro_torch/csrc`` with nvcc (sm_90a);
  3. kernel A (flash forward) against its plain version on the card, in
     float32 and bf16, the zigzag, window, dead-row and ragged edge cases
     included, and the decode cases (Sq 1 and 3, GQA groups 1/2/8, window,
     dead rows, ragged Sk) each run twice and required bitwise equal; each
     call's log names the instance that served it (decode: Sq <= 4; wgmma:
     bf16, D 64/128, Sq > 4; else the CUDA-core one);
  4. kernel C (fused paged decode) against its plain version on the card,
     each case run twice and required bitwise equal, and two calls on two
     streams at once each bitwise equal to its single-stream result;
  5. the paged engine and the dense-slab engine at qwen3-1.7b widths (2
     layers, float32) on the kernels, every emitted token teacher-forced
     against the plain path;
  6. the serving path: qwen3-1.7b at full width and depth (28 layers, bf16,
     seeded random weights) served by the paged engine and the dense-slab
     engine, each with its own kernel launch counts, held against its
     prefill ticks and decode steps, every step's logits finite; with
     ``--profile``, the paged and the
     dense-slab runs once more under torch.profiler (device busy share and
     the kernels that take the most device time; adds minutes);
  7. kernels B1 and B2 (flash backward: dq; dk/dv) against their plain
     version on the card, in float32 on the backward test cases (the
     CUDA-core instances), in bf16 at the training shape and on zigzag,
     window, dead-row and ragged cases at D 64 and 128 (the wgmma
     instances), each run twice and required bitwise equal, gradients of
     rows that see no key exactly 0; B1, B2 and A timed at the training
     shape beside SDPA;
  8. one training step at qwen3-1.7b widths (2 layers, float32) on the
     kernels against the plain path: loss, every gradient, and the
     parameters after one AdamW step; then one bf16 step (kernel A's wgmma
     instance feeding B1/B2): loss and every gradient;
  9. the training path: qwen3-1.7b at full width and depth through the
     ``Trainer`` (AdamW, float32 parameters, bf16 compute, remat "full"),
     batch 2 x seq 4096, one warmup step and three timed steps whose launch
     counts must be 56 of A, 28 of B1 and 28 of B2 per step; with
     ``--profile``, one more step under torch.profiler;
 10. the ring strategies (tokenring with its accumulator travelling in
     float32 and in bf16, tokenring_faithful, ring, ring_bidir) on the
     virtual ring of P = 2, 4 and 8 ranks folded into the batch dimension
     of the card, at qwen3-1.7b attention widths in bf16 and float32:
     forward (out, lse) and q/k/v gradients on the kernels against the same
     ring on the plain versions, overlap=True bitwise equal to
     overlap=False, launches equal to the schedule's Computes, link bytes
     equal to the cost model; TokenRing at the training shape under
     torch.profiler (the side stream's copies against the compute stream's
     kernels) with the overlap=True and overlap=False wall times; one
     2-layer float32 training step through TokenRing at P = 4 against the
     plain path;
 11. the ring training path (this slice's main path): qwen3-1.7b at full
     width and depth through the ``Trainer`` with TokenRing over 4 virtual
     ranks, as phase 9 otherwise, launch counts 448 of A, 224 of B1 and 224
     of B2 per step, then the same steps with overlap=False; with
     ``--profile``, one more step under torch.profiler;
 12. sequence-parallel serving on the virtual ring: ``sp_decode``,
     ``sp_decode_paged`` and ``sp_prefill`` at qwen3-1.7b attention widths
     (16/8 heads, D 128), f32 and bf16, P = 2, 4 and 8, window None and 48,
     on the kernels against the same ranks on the plain versions at phase
     3's and 4's limits (ranks with no live key, a table whose pages all sit
     on one stripe, one spanning every stripe, a row with no key exactly
     (0, -inf) before finalize and 0 after), each kernel case run twice and
     bitwise equal, all-reduce bytes equal to the cost models; the same
     functions in bf16 at P = 4 at phase 13's own shapes (dense slab of 4
     slots x 2048 keys, prefill chunks of 256 against it and against the
     paged view of 8 slots, paged decode of 8 slots with 128-entry tables
     into 1024 pages), bitwise repeated, with each kernel call they make
     held against its plain version and timed beside it, SDPA and its
     bound; then phase 5's engines at ``sp_degree=4``, teacher-forced
     against the plain SP-1 path, with launches equal to the products of
     ticks and steps;
 13. the SP serving path (this slice's main path): phase 6's two runs with
     ``sp_degree=4`` (virtual ring) and nothing else changed, with launch
     counts per prefill tick and decode step, the all-reduce bytes per step,
     rank and direction against ``decode_comm_cost``, the pages each stripe
     holds at the peak and the share of tokens equal to phase 6's; with
     ``--profile``, both runs once more under torch.profiler; then every
     SP-4 chain fed back through phase 6's SP-1 bundle (and through the SP-4
     and the plain bundles as yardsticks), each SP-4 token within
     ``WITNESS_GAP`` of the row spread below SP 1's max logit;
 14. a ``{"kernels": [...]}`` summary line, the card line, and last the
     ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Timings are CUDA-event medians after warmup;
the serving-shape rows of kernels A and C also give each call's device
time from torch.profiler (their ``ms``), which leaves out the host's time
between launches.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor core / fp32 CUDA core
PAD_POS = 2**30


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median per-call device time over ``reps`` runs of ``iters`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, iters: int = 30) -> float:
    """Device time of one call: the kernels' own time on the card (sum of
    every kernel the call launches, from torch.profiler) over ``iters``
    calls.  Unlike :func:`time_ms` it leaves out the host's time between
    launches, which a call of a few tens of microseconds can exceed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3


def compare(name, got, want, atol, rtol, lse_tol, quiet=False):
    """Raise unless kernel ``(out, lse)`` matches the plain version; dead
    rows (plain lse = -inf) must be exactly (0, -inf).  Returns max |err|
    (and logs it unless ``quiet``)."""
    import torch

    (out, lse), (ref_out, ref_lse) = got, want
    dead = torch.isneginf(ref_lse)
    if not torch.equal(torch.isneginf(lse), dead):
        raise AssertionError(f"{name}: dead-row pattern differs from the plain version")
    if dead.any():
        if not (out.float()[dead] == 0).all():
            raise AssertionError(f"{name}: dead rows are not exactly 0")
    live = ~dead
    err = (out.float() - ref_out.float()).abs()
    lerr = (lse[live] - ref_lse[live]).abs()
    ok_out = torch.all(err <= atol + rtol * ref_out.float().abs())
    ok_lse = lerr.numel() == 0 or torch.all(lerr <= lse_tol)
    max_err = float(err.max()) if err.numel() else 0.0
    max_lerr = float(lerr.max()) if lerr.numel() else 0.0
    if not (ok_out and ok_lse) or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: max |out err| {max_err:.3e}, max |lse err| {max_lerr:.3e}")
    if not quiet:
        log(f"  ok {name}: max|out err| {max_err:.3e} max|lse err| {max_lerr:.3e}")
    return max_err


def tolerances(dtype):
    import torch

    # Both sides accumulate in float32 from the same inputs, only in another
    # order: f32 holds out and lse to 1e-4.  bf16 adds the rounding of out
    # to bf16, at most one bf16 step apart (relative 2**-7 < 1e-2); lse stays
    # float32, so 1e-3 absolute, with no relative term.
    if dtype == torch.bfloat16:
        return dict(atol=5e-3, rtol=1e-2, lse_tol=1e-3)
    return dict(atol=1e-4, rtol=1e-4, lse_tol=1e-4)


# ---------------------------------------------------------------------------
# phase 3: kernel A
# ---------------------------------------------------------------------------

SHAPES = [(1, 128, 128, 1, 1, 64), (2, 256, 256, 4, 2, 64), (1, 128, 256, 4, 1, 128),
          (1, 512, 512, 2, 2, 128)]


def flash_bytes_flops(q, k, q_pos, k_pos, causal, window):
    """What this call's data needs: every query and live key read once, the
    outputs written once, and 4*D flops per visible (query, key, head)."""
    from repro_torch.kernels.ref import visibility_mask

    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    live_keys = int((k_pos < PAD_POS // 2).sum())
    e = q.element_size()
    nbytes = (q.numel() * e + 2 * live_keys * Hkv * D * e + q_pos.numel() * 4
              + k_pos.numel() * 4 + q.numel() * e + B * Sq * Hq * 4)
    pairs = int(visibility_mask(q_pos, k_pos, causal=causal, window=window).sum())
    flops = 4.0 * D * Hq * pairs
    return nbytes, flops


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_flash(torch, dev):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import pick_block

    def run(q, k, v, qp, kp, causal, window, scale=None):
        scale = scale or 1.0 / q.shape[-1] ** 0.5
        got = fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=causal, window=window,
                                          scale=scale)
        want = fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=causal, window=window,
                                            scale=scale, block_k=pick_block(k.shape[1], 512))
        return got, want

    def short(dtype):
        return {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]

    def check(label, q, k, v, qp, kp, causal, window):
        """Kernel vs plain at the tolerances of q's type; the log names the
        instance of kernel A that served the call.  A decode-instance call
        runs twice and must be bitwise equal (its splits merge in a fixed
        order)."""
        inst = fa.flash_fwd_instance(q.dtype, q.shape[1], q.shape[-1])
        name = f"A {short(q.dtype)} {label} [{inst}]"
        got, want = run(q, k, v, qp, kp, causal, window)
        if inst == "decode":
            again, _ = run(q, k, v, qp, kp, causal, window)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name}: two runs on the same inputs differ")
            name += " bitwise repeatable"
        return compare(name, got, want, **tolerances(q.dtype))

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for (B, Sq, Sk, Hq, Hkv, D) in SHAPES:
            for causal in (False, True):
                q, k, v = rnd((B, Sq, Hq, D), dtype), rnd((B, Sk, Hkv, D), dtype), rnd(
                    (B, Sk, Hkv, D), dtype)
                qp = torch.arange(Sq, device=dev, dtype=torch.int32).expand(B, Sq).contiguous()
                kp = torch.arange(Sk, device=dev, dtype=torch.int32).expand(B, Sk).contiguous()
                check(f"{(B, Sq, Sk, Hq, Hkv, D)} causal={causal}", q, k, v, qp, kp, causal,
                      None)
    # zigzag positions (P = 4), sliding window, dead rows: each in float32
    # (the CUDA-core instance) and in bf16 (the wgmma instance at D = 64)
    S, P = 256, 4
    half = S // (2 * P)
    zz = []
    for j in range(P):
        zz += list(range(j * half, (j + 1) * half))
        zz += list(range((2 * P - 1 - j) * half, (2 * P - j) * half))
    q32, k32, v32 = (rnd((2, S, 2, 64), torch.float32) for _ in range(3))
    zp = torch.tensor(zz, device=dev, dtype=torch.int32).expand(2, S).contiguous()
    ar = torch.arange(S, device=dev, dtype=torch.int32).expand(2, S).contiguous()
    kp_dead = ar.clone()
    kp_dead[1] = PAD_POS
    qp_dead = ar.clone()
    qp_dead[0, :16] = -1
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
        check("zigzag", q, k, v, zp, zp, True, None)
        check("window=48", q, k, v, ar, ar, True, 48)
        check("dead rows", q, k, v, qp_dead, kp_dead, True, None)
    # ragged edges: lengths that are no multiple of either instance's tiles.
    # The D=64/128 cases draw from a generator of their own, so the serving
    # shapes below get the same data as in earlier runs of this script.
    gen_ragged = torch.Generator(device=dev).manual_seed(1)
    for (Sq, Sk, D) in ((37, 45, 32), (37 + 128, 45 + 128, 64), (37 + 128, 45 + 128, 128)):
        g = gen if D == 32 else gen_ragged
        q32, k32, v32 = (torch.randn(shape, generator=g, device=dev)
                         for shape in ((2, Sq, 4, D), (2, Sk, 2, D), (2, Sk, 2, D)))
        qp = (torch.arange(Sq, device=dev, dtype=torch.int32) + 8).expand(2, Sq).contiguous()
        kp = torch.arange(Sk, device=dev, dtype=torch.int32).expand(2, Sk).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            check(f"ragged {Sq}x{Sk} D={D}", q32.to(dtype), k32.to(dtype), v32.to(dtype), qp, kp,
                  True, None)
    # no keys at all: every row is dead, exactly (0, -inf), on both instances
    qp = torch.arange(165, device=dev, dtype=torch.int32).expand(1, 165).contiguous()
    kp = torch.empty((1, 0), device=dev, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((1, 165, 2, 128), generator=gen_ragged, device=dev).to(dtype)
        k = torch.empty((1, 0, 1, 128), device=dev, dtype=dtype)
        out, lse = fa.flash_attention_fwd_cuda(q, k, k, qp, kp, causal=True, window=None,
                                               scale=128 ** -0.5)
        inst = fa.flash_fwd_instance(dtype, 165, 128)
        if not (torch.equal(out, torch.zeros_like(out)) and torch.isneginf(lse).all()):
            raise AssertionError(f"A {short(dtype)} no keys [{inst}]: rows are not (0, -inf)")
        log(f"  ok A {short(dtype)} no keys Sq=165 Sk=0 [{inst}]: every row exactly (0, -inf)")

    phase_flash_decode(torch, dev, check)

    # serving shapes of qwen3-1.7b: B=8, Hq=16, Hkv=8, D=128, Sk=2048 (the
    # resident call of a prefill chunk and the dense decode call), each held
    # in float32 and in bfloat16; timed in bfloat16, the model's type.
    rng_lengths = torch.randint(128, 2049 - 256, (8,), generator=gen, device=dev)
    B, Hq, Hkv, D, Sk = 8, 16, 8, 128, 2048
    k32, v32 = rnd((B, Sk, Hkv, D), torch.float32), rnd((B, Sk, Hkv, D), torch.float32)
    k, v = k32.to(torch.bfloat16), v32.to(torch.bfloat16)
    ar = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
    kp = torch.where(ar < rng_lengths[:, None], ar, PAD_POS).to(torch.int32).contiguous()
    # the chunk-local call of a 256-token prefill chunk: Sq = Sk = 256
    cp = (rng_lengths[:, None] + torch.arange(256, device=dev)[None]).to(torch.int32).contiguous()
    qc, kc, vc = (rnd(shape, torch.float32) for shape in ((B, 256, Hq, D), (B, 256, Hkv, D),
                                                          (B, 256, Hkv, D)))
    for dtype in (torch.float32, torch.bfloat16):
        check("chunk-local Sq=Sk=256", qc.to(dtype), kc.to(dtype), vc.to(dtype), cp, cp, True,
              None)
    rows = {}
    for Sq in (1, 256):
        q32 = rnd((B, Sq, Hq, D), torch.float32)
        q = q32.to(torch.bfloat16)
        qp = (rng_lengths[:, None] - (1 if Sq == 1 else 0)
              + torch.arange(Sq, device=dev)[None]).to(torch.int32).contiguous()
        check(f"serving Sq={Sq} Sk={Sk}", q32, k32, v32, qp, kp, True, None)
        err = check(f"serving Sq={Sq} Sk={Sk}", q, k, v, qp, kp, True, None)
        scale = 1.0 / D ** 0.5
        mask = (kp[:, None, None, :] < PAD_POS // 2) & (qp[:, None, :, None] >= kp[:, None, None, :])
        # yardstick only: SDPA gives out without lse; KV repeated for GQA
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2) for x in (k, v))
        fns = (lambda: fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True, window=None,
                                                   scale=scale),
               lambda: fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=True, window=None,
                                                    scale=scale, block_k=512),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        # CUDA events around the calls (host gaps between launches included)
        ev_ms, ev_plain, ev_lib = (time_ms(f, iters=it) for f, it in zip(fns, (10, 3, 10)))
        # the kernels' own device time (torch.profiler)
        ms, plain_ms, lib_ms = (device_ms(f, iters=it) for f, it in zip(fns, (30, 3, 30)))
        nbytes, flops = flash_bytes_flops(q, k, qp, kp, True, None)
        bms, by = bound(nbytes, flops, "bfloat16")
        inst = fa.flash_fwd_instance(q.dtype, Sq, D)
        rows[Sq] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                        event_ms=ev_ms, event_plain_ms=ev_plain, event_library_ms=ev_lib,
                        max_abs_err=err, instance=inst, timing="device time (torch.profiler)",
                        shape=f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} bf16")
        log(f"  A serving Sq={Sq} [{inst}]: device kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms; events kernel {ev_ms:.4f} ms, plain {ev_plain:.4f} ms, "
            f"sdpa {ev_lib:.4f} ms; bound {bms:.4f} ms ({by}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s at device time")
    return rows


# Decode-instance cases of kernel A (Sq <= 4): id, (B, Sq, Sk, Hq, Hkv, D),
# causal, window, layout.  GQA groups 1, 2 and 8 at Sq 1 and 3 (1 to 24 rows
# a block), 32 rows of one KV head at Sq 4 (two row chunks of 64), a window,
# dead rows, ragged Sk (no multiple of a tile or of a split), Sk shorter
# than one tile, D 64 and 32, and a non-causal call.
DECODE_CASES = [
    (f"g{Hq // Hkv} Sq={Sq}", (3, Sq, 1000, Hq, Hkv, 128), True, None, "lengths")
    for Sq in (1, 3) for Hq, Hkv in ((4, 4), (8, 4), (16, 2))
] + [
    ("mqa 32/1 Sq=4", (2, 4, 456, 32, 1, 128), True, None, "lengths"),
    ("window=48", (3, 1, 488, 8, 4, 128), True, 48, "lengths"),
    ("window=48 Sq=3", (3, 3, 488, 8, 4, 128), True, 48, "lengths"),
    ("dead rows", (3, 3, 472, 8, 4, 128), True, None, "dead"),
    ("Sk=20 < tile", (2, 1, 20, 8, 4, 128), True, None, "lengths"),
    ("D=64", (3, 3, 1000, 8, 4, 64), True, None, "lengths"),
    ("D=32", (3, 1, 1000, 8, 2, 32), True, None, "lengths"),
    ("noncausal", (2, 3, 300, 8, 4, 128), False, None, "lengths"),
]


def decode_positions(torch, dev, B, Sq, Sk, layout, gen):
    """Each batch row's used length drawn in [1, Sk] (the first is Sk), keys
    past it padding, and its Sq queries at the last Sq positions.  "dead":
    batch row 1 has only padding keys and the first query of batch row 0
    precedes every key."""
    lengths = torch.randint(1, Sk + 1, (B,), generator=gen, device=dev)
    lengths[0] = Sk
    ar = torch.arange(Sk, device=dev, dtype=torch.int32)[None]
    kp = torch.where(ar < lengths[:, None], ar, PAD_POS).to(torch.int32).contiguous()
    qp = (lengths[:, None] - Sq + torch.arange(Sq, device=dev)[None]).to(torch.int32)
    if layout == "dead":
        kp[1] = PAD_POS
        qp[0, 0] = -1
    return qp.contiguous(), kp


def phase_flash_decode(torch, dev, check):
    """Kernel A's decode instance on DECODE_CASES in float32 and bf16, each
    run twice (bitwise equal) by ``check``; then a call with no keys."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(4)
    for case_id, (B, Sq, Sk, Hq, Hkv, D), causal, window, layout in DECODE_CASES:
        qp, kp = decode_positions(torch, dev, B, Sq, Sk, layout, gen)
        q32, k32, v32 = (torch.randn(shape, generator=gen, device=dev)
                         for shape in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
        for dtype in (torch.float32, torch.bfloat16):
            check(f"decode {case_id} {(B, Sq, Sk, Hq, Hkv, D)}", q32.to(dtype), k32.to(dtype),
                  v32.to(dtype), qp, kp, causal, window)
    qp = torch.zeros((2, 1), device=dev, dtype=torch.int32)
    kp = torch.empty((2, 0), device=dev, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((2, 1, 8, 128), generator=gen, device=dev).to(dtype)
        k = torch.empty((2, 0, 4, 128), device=dev, dtype=dtype)
        out, lse = fa.flash_attention_fwd_cuda(q, k, k, qp, kp, causal=True, window=None,
                                               scale=128 ** -0.5)
        inst = fa.flash_fwd_instance(dtype, 1, 128)
        if not (torch.equal(out, torch.zeros_like(out)) and torch.isneginf(lse).all()):
            raise AssertionError(f"A {dtype} no keys [{inst}]: rows are not (0, -inf)")
        log(f"  ok A {str(dtype)[6:]} decode no keys Sq=1 Sk=0 [{inst}]: every row exactly "
            "(0, -inf)")


# ---------------------------------------------------------------------------
# phase 4: kernel C
# ---------------------------------------------------------------------------

PAGED_CASES = [
    ("ps1_mha", 1, (2, 2), (1, 3), None),
    ("ps4_gqa", 4, (8, 2), (3, 4, 5), None),
    ("ps8_mqa", 8, (4, 1), (8, 23), None),
    ("ps16_boundary", 16, (4, 4), (15, 16, 17, 64), None),
    ("ps8_window", 8, (4, 2), (40, 7), 16),
    # rows longer than one split of the kernel, so the merge combines
    # several partials (the plain version never splits)
    ("ps4_splits", 4, (8, 2), (300, 77, 129), None),
    ("ps8_window_splits", 8, (4, 2), (500, 33), 40),
    # GQA groups 8 and 16: the decode core's two- and four-row-group layouts
    ("ps16_group8", 16, (16, 2), (200, 31), None),
    ("ps16_group16", 16, (16, 1), (600, 5), None),
    # MQA with a group of 32: 8 rows a warp (no cap at 16 since the row chunks)
    ("ps16_group32_mqa", 16, (32, 1), (300, 40), None),
]


def paged_case_data(case_id, ps, heads, lengths, D=32):
    """Reversed page order, sentinel table tails, random K/V under PAD_POS."""
    import numpy as np

    Hq, Hkv = heads
    B = len(lengths)
    W = max(-(-L // ps) for L in lengths) + 1
    n_pages = sum(-(-L // ps) for L in lengths) + 2
    rng = np.random.default_rng(zlib.crc32(repr((case_id, ps, heads, tuple(lengths))).encode()))
    k_pool = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    v_pool = rng.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32)
    pos_pool = np.full((n_pages, ps), PAD_POS, np.int32)
    bt = np.full((B, W), n_pages, np.int32)
    free = list(range(n_pages))
    for b, L in enumerate(lengths):
        pages = [free.pop() for _ in range(-(-L // ps))][::-1]
        for ip, pg in enumerate(pages):
            bt[b, ip] = pg
            for off in range(ps):
                if ip * ps + off < L:
                    pos_pool[pg, off] = ip * ps + off
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    q_pos = (np.asarray(lengths, np.int32) - 1)[:, None]
    return [q, k_pool, v_pool, pos_pool, bt, q_pos]


def phase_paged(torch, dev):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    def to_dev(data, dtype):
        return [torch.from_numpy(x).to(dev).to(dtype if x.dtype.kind == "f" else torch.int32)
                .contiguous() for x in data]

    def run(data, lengths, window):
        """Kernel (run twice: bitwise equal or raise) and plain version."""
        q, kp, vp, pos, bt, qp = data
        scale = 1.0 / q.shape[-1] ** 0.5
        got = pa.paged_decode_fwd_cuda(q, kp, vp, pos, bt, qp, window=window, scale=scale)
        again = pa.paged_decode_fwd_cuda(q, kp, vp, pos, bt, qp, window=window, scale=scale)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError("C: two runs on the same inputs differ")
        want = pa.paged_decode_fwd_torch(q, kp, vp, pos, bt, qp, lengths=lengths, window=window,
                                         scale=scale, block_k=512)
        return got, want

    def splits(data):
        q, kp, _, _, bt, _ = data
        B, _, Hq, _ = q.shape
        n_pages, ps, Hkv, _ = kp.shape
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        return fa.decode_split_rule(bt.shape[1] * ps, fa.decode_units(B, Hq, Hkv, 1), sms)[1]

    for dtype in (torch.float32, torch.bfloat16):
        for case_id, ps, heads, lengths, window in PAGED_CASES:
            data = to_dev(paged_case_data(case_id, ps, heads, lengths), dtype)
            lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
            compare(f"C {str(dtype)[6:]} {case_id} ({splits(data)} splits) bitwise repeatable",
                    *run(data, lens, window), **tolerances(dtype))
    # alias poisoning: the page a clamped sentinel would alias holds huge,
    # live-looking K/V at visible positions; an unmapped row stays (0, -inf)
    raw = paged_case_data("dead", 4, (4, 2), (9, 5))
    n_pages = raw[1].shape[0]
    raw[4][1, :] = n_pages
    raw[1][n_pages - 1] = 1e3
    raw[2][n_pages - 1] = 1e3
    raw[3][n_pages - 1] = 0
    data = to_dev(raw, torch.float32)
    got, want = run(data, torch.tensor([9, 0], device=dev, dtype=torch.int32), None)
    compare("C f32 alias poisoning", (got[0], got[1]), want, **tolerances(torch.float32))
    if not (torch.equal(got[0][1], torch.zeros_like(got[0][1])) and torch.isneginf(got[1][1]).all()):
        raise AssertionError("C: unmapped row is not the merge identity")

    # serving shape: ps=16, B=8, Hq=16, Hkv=8, D=128, lengths up to 2048,
    # reversed pages, sentinel tails, bf16
    import numpy as np

    rng = np.random.default_rng(1)
    lengths = rng.integers(128, 2049, 8).tolist()
    raw = paged_case_data("serving", 16, (16, 8), tuple(lengths), D=128)
    lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
    data = to_dev(raw, torch.float32)
    compare(f"C f32 serving ps=16 ({splits(data)} splits) bitwise repeatable",
            *run(data, lens, None), **tolerances(torch.float32))
    data = to_dev(raw, torch.bfloat16)
    err = compare(f"C bf16 serving ps=16 ({splits(data)} splits) bitwise repeatable",
                  *run(data, lens, None), **tolerances(torch.bfloat16))
    q, kp, vp, pos, bt, qp = data
    scale = 1.0 / 128 ** 0.5
    two_streams(torch, dev, pa, data, splits(data))
    kern = lambda: pa.paged_decode_fwd_cuda(q, kp, vp, pos, bt, qp, window=None,  # noqa: E731
                                            scale=scale)
    plain = lambda: pa.paged_decode_fwd_torch(q, kp, vp, pos, bt, qp, lengths=lens,  # noqa: E731
                                              window=None, scale=scale, block_k=512)
    ev_ms, ev_plain = time_ms(kern, iters=20), time_ms(plain, iters=5)
    ms, plain_ms = device_ms(kern), device_ms(plain, iters=5)
    pages_used = int((bt < kp.shape[0]).sum())
    ps, Hkv, D = 16, 8, 128
    nbytes = (pages_used * ps * Hkv * D * 2 * 2 + pages_used * ps * 4 + bt.numel() * 4
              + 2 * q.numel() * 2 + q.shape[0] * q.shape[2] * 4)
    flops = 4.0 * D * 16 * sum(lengths)
    bms, by = bound(nbytes, flops, "bfloat16")
    log(f"  C serving: device kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; events kernel "
        f"{ev_ms:.4f} ms, plain {ev_plain:.4f} ms; bound {bms:.4f} ms ({by}), "
        f"{nbytes / ms / 1e6:.1f} GB/s over {pages_used} pages at device time")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                event_ms=ev_ms, event_plain_ms=ev_plain, timing="device time (torch.profiler)",
                max_abs_err=err, shape=f"B=8 ps=16 Hq=16 Hkv=8 D=128 pages={pages_used} bf16")


def two_streams(torch, dev, pa, data, n_splits, rounds=20):
    """Two kernel C calls on two streams at once (different queries, the
    same pool), ``rounds`` times: each result bitwise equal to its
    single-stream result.  The decode core's merge counters are per
    (device, stream), so launches on two streams never share them."""
    q, kp, vp, pos, bt, qp = data
    scale = 1.0 / q.shape[-1] ** 0.5
    qs = (q, (-q).contiguous())
    solo = [pa.paged_decode_fwd_cuda(x, kp, vp, pos, bt, qp, window=None, scale=scale)
            for x in qs]
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    main = torch.cuda.current_stream(dev)
    got = [[], []]
    for st in streams:
        st.wait_stream(main)
    for _ in range(rounds):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append(pa.paged_decode_fwd_cuda(qs[i], kp, vp, pos, bt, qp, window=None,
                                                       scale=scale))
    torch.cuda.synchronize(dev)
    for i in range(2):
        for out, lse in got[i]:
            if not (torch.equal(out, solo[i][0]) and torch.equal(lse, solo[i][1])):
                raise AssertionError(f"C on two streams: stream {i}'s result differs from its "
                                     "single-stream result")
    log(f"  ok C two streams at once ({n_splits} splits): {rounds} rounds x 2 calls bitwise "
        "equal to their single-stream results")


# ---------------------------------------------------------------------------
# phases 5 and 6: the engine
# ---------------------------------------------------------------------------


def make_prompts(n, lo, hi, vocab, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(L)).astype(np.int32) for L in lengths]


def phase_e2e_checked(torch, dev, sp_degree=1, label="phase 5"):
    """qwen3-1.7b widths, 2 layers, float32: the paged engine (kernels A and
    C) and the dense-slab engine (kernel A, its decode instance for every
    decode step), each emitted token teacher-forced against the plain path
    at SP 1 on the card.  With ``sp_degree > 1`` the engines serve over that
    many virtual ranks (phase 12).  Launches of A and C must equal the
    products of the prefill ticks and decode steps."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda
    from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = ARCHS["qwen3-1.7b"].with_(n_layers=2, dtype="float32")
    bundle = build_model(cfg, ParallelContext(device="cuda", sp_degree=sp_degree))
    params = bundle.init(0)
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda"))
    max_len = 512
    for path, kw in (("paged", dict(page_size=16)), ("dense-slab", {})):
        eng = ServingEngine(bundle, params, max_batch=4, max_len=max_len, prefill_chunk=128,
                            token_budget=256, device=dev, **kw)
        a0, c0 = flash_attention_fwd_cuda.launches, paged_decode_fwd_cuda.launches
        reqs = [eng.submit(p, max_new_tokens=16)
                for p in make_prompts(6, 40, 300, cfg.vocab_size)]
        eng.run()
        ran_a = flash_attention_fwd_cuda.launches - a0
        ran_c = paged_decode_fwd_cuda.launches - c0
        want = serving_launches(cfg.n_layers, eng.counters["prefill_steps"],
                                eng.counters["decode_steps"], paged=path == "paged")
        if (ran_a, ran_c) != (want["flash_attention_fwd"], want["paged_decode_fwd"]):
            raise AssertionError(f"{label} {path}: launches A {ran_a}, C {ran_c}, expected {want}")
        worst = 0.0
        for r in reqs:
            if len(r.output) != 16:
                raise AssertionError(f"{path} request {r.uid} emitted {len(r.output)} tokens")
            state = plain.init_serve_state(1, max_len, dev)
            head = torch.from_numpy(r.prompt[:-1][None].copy()).to(dev)
            plain.prefill_chunk(params, head, state,
                                torch.tensor([head.shape[1]], device=dev, dtype=torch.int32))
            feed = [int(r.prompt[-1])] + r.output[:-1]
            for t, (tok_in, tok_out) in enumerate(zip(feed, r.output)):
                logits, state = plain.decode_step(params, torch.tensor([tok_in], device=dev),
                                                  state)
                row = logits[0].float()
                gap = float(row.max() - row[tok_out])
                worst = max(worst, gap)
                if gap > 1e-3:
                    raise AssertionError(f"{path} req {r.uid} step {t}: token {tok_out} is "
                                         f"{gap:.2e} below the plain path's max logit")
        del eng
        log(f"  ok {label} {path} (SP {sp_degree}): {len(reqs)} requests x 16 tokens within "
            f"1e-3 of the plain SP-1 path (worst gap {worst:.2e}); launches A {ran_a}, C {ran_c}")


def serving_launches(L, ticks, steps, *, paged):
    """Launches of a serving run: every prefill tick runs A twice per layer
    (resident + chunk-local partial, the latter once over every rank on the
    virtual ring); a decode step runs C (paged) or A (dense) once per layer,
    over every rank's rows in one launch; serving runs no backward."""
    if paged:
        want = {"flash_attention_fwd": 2 * L * ticks, "paged_decode_fwd": L * steps}
    else:
        want = {"flash_attention_fwd": 2 * L * ticks + L * steps, "paged_decode_fwd": 0}
    return {**want, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}


def serve_run(torch, dev, bundle, params, *, n_requests, paged, seed=0, outputs=None):
    """Phase 6's request mix through a fresh engine; ``outputs`` (a list)
    receives every request's tokens."""
    from repro_torch.serving.engine import ServingEngine

    kw = dict(page_size=16) if paged else {}
    eng = ServingEngine(bundle, params, max_batch=8 if paged else 4, max_len=2048,
                        prefill_chunk=256, token_budget=512, device=dev, **kw)
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def checked(step):
        # every step's logits must be finite: one device flag, read once
        def run(*args):
            logits, state = step(*args)
            finite.logical_and_(torch.isfinite(logits).all())
            return logits, state
        return run

    eng._step, eng._chunk_step = checked(eng._step), checked(eng._chunk_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32)
            for p in make_prompts(n_requests, 128, 1024, bundle.cfg.vocab_size, seed)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError("a serving step gave non-finite logits")
    for r in reqs:
        if r.status != "done" or len(r.output) != 32:
            raise AssertionError(f"request {r.uid}: {r.status}, {len(r.output)} tokens")
        if not all(0 <= t < bundle.cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: token out of vocabulary")
    if outputs is not None:
        outputs.extend(r.output for r in reqs)
    s = eng.stats()
    s["wall_s"] = wall
    s["tok_s"] = s["tokens"] / wall
    s["prompt_tokens"] = int(sum(len(r.prompt) for r in reqs))
    s["max_batch"] = eng.max_batch
    del eng
    return s


def device_rows(torch, prof):
    """``(device us, count, name)`` of every kernel in a profile, largest first."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    return rows


def port_kernel_rows(rows, busy_s):
    """Log and return the profile rows of the port's own kernels (``rt::``),
    whether or not they are among the largest."""
    mine = [r for r in rows if "rt::" in r[2]]
    for us, count, key in mine:
        log(f"    port kernel {us / 1e3:10.2f} ms {100 * us / 1e6 / busy_s:5.1f}% x{count:6d} "
            f"{key[:70]}")
    return [{"ms": us / 1e3, "count": c, "kernel": k[:120]} for us, c, k in mine]


def profile_run(torch, dev, bundle, params, unprofiled_wall_s, paged=True):
    """The paged (or dense-slab) run once more under torch.profiler: device
    busy time (sum of kernel times on the one stream) against the profiled
    wall, and the kernels that take the most device time.  The profiler adds
    host time per op, so its wall is above the unprofiled run's; the busy
    time over the unprofiled run's wall (same requests, same kernels) is
    printed beside it as the estimate of the unprofiled run's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = serve_run(torch, dev, bundle, params, n_requests=16 if paged else 4, paged=paged)
    rows = device_rows(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"  profiled {'paged' if paged else 'dense-slab'} run: wall {s['wall_s']:.3f} s, "
        f"device busy {busy_s:.3f} s "
        f"({100 * busy_s / s['wall_s']:.1f}%), idle {100 * (1 - busy_s / s['wall_s']):.1f}%; "
        f"against the unprofiled wall {unprofiled_wall_s:.3f} s: busy "
        f"{100 * busy_s / unprofiled_wall_s:.1f}%, idle "
        f"{100 * (1 - busy_s / unprofiled_wall_s):.1f}%")
    for us, count, key in rows[:10]:
        log(f"    {us / 1e3:10.2f} ms {100 * us / 1e6 / busy_s:5.1f}% x{count:6d} {key[:90]}")
    return {"wall_s": s["wall_s"], "device_busy_s": busy_s,
            "unprofiled_wall_s": unprofiled_wall_s,
            "top": [{"ms": us / 1e3, "count": c, "kernel": k[:120]} for us, c, k in rows[:10]],
            "port_kernels": port_kernel_rows(rows, busy_s)}


def phase_full(torch, dev, with_profile, sp_degree=1, reference=None):
    """qwen3-1.7b at full width and depth (seeded weights) through the paged
    and the dense-slab engine, with ``sp_degree`` virtual ranks (phase 13)
    or one (phase 6).  Returns each run's launches and the tokens it
    emitted; at SP > 1 the all-reduce bytes of each run must equal the cost
    models' per step and rank, and the share of tokens equal to
    ``reference`` (phase 6's) is logged."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.core.decode import decode_comm_cost, prefill_comm_cost
    from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda
    from repro_torch.models.registry import build_model

    cfg = ARCHS["qwen3-1.7b"]
    pctx = ParallelContext(device="cuda", sp_degree=sp_degree)
    bundle = build_model(cfg, pctx)
    t0 = time.perf_counter()
    params = bundle.init(0)
    torch.cuda.synchronize()
    log(f"  weights: {cfg.n_layers} layers, {cfg.dtype}, seeded init "
        f"{time.perf_counter() - t0:.1f} s; SP degree {sp_degree}"
        + (" (virtual ring)" if sp_degree > 1 else ""))
    serve_run(torch, dev, bundle, params, n_requests=2, paged=True, seed=99)  # warmup
    torch.cuda.reset_peak_memory_stats()
    suffix = f"_sp{sp_degree}" if sp_degree > 1 else ""
    runs, launches, outputs = {}, {}, {}
    for path, n_requests, paged in (("paged", 16, True), ("dense", 4, False)):
        name = path + suffix
        outputs[path] = []
        if sp_degree > 1:
            pctx.ring.reset_counts()
        reset_launch_counts()
        s = serve_run(torch, dev, bundle, params, n_requests=n_requests, paged=paged,
                      outputs=outputs[path])
        got = {**launch_counts(), "paged_decode_fwd": paged_decode_fwd_cuda.launches}
        L, ticks, steps = cfg.n_layers, s["prefill_steps"], s["decode_steps"]
        want = serving_launches(L, ticks, steps, paged=paged)
        if got != want:
            raise AssertionError(f"{name} path: launches {got}, expected {want} from "
                                 f"{ticks} prefill ticks and {steps} decode steps")
        s["launches_per_prefill_tick"] = 2 * L
        s["launches_per_decode_step"] = L
        if sp_degree > 1:
            # every layer of a decode step all-reduces B rows, of a prefill
            # tick B x chunk rows (the resident partial); tables priced apart
            Bm, heads = s["max_batch"], (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
            dec = decode_comm_cost(Bm, 1, *heads, sp_degree).fwd_bytes * L
            pre = prefill_comm_cost(Bm, 256, *heads, sp_degree).fwd_bytes * L
            counted = dict(pctx.ring.link_bytes)
            want_bytes = dec * steps + pre * ticks
            if counted != {"fwd": want_bytes, "bwd": want_bytes}:
                raise AssertionError(f"{name}: all-reduce bytes {counted}, cost models "
                                     f"{want_bytes} a direction ({steps} steps x {dec} + "
                                     f"{ticks} ticks x {pre})")
            s["allreduce_bytes_per_decode_step"] = dec
            s["allreduce_bytes_per_prefill_tick"] = pre
            s["allreduce_bytes_run"] = counted
        if reference is not None:
            pairs = [(a, b) for x, y in zip(outputs[path], reference[path]) for a, b in zip(x, y)]
            s["tokens_equal_to_sp1_share"] = sum(a == b for a, b in pairs) / len(pairs)
            # a greedy chain that flips one near-tie differs from there on
            first = [next((i for i, (a, b) in enumerate(zip(x, y)) if a != b), len(x))
                     for x, y in zip(outputs[path], reference[path])]
            s["requests_equal_to_sp1"] = sum(f == 32 for f in first)
            s["mean_first_difference"] = sum(first) / len(first)
        runs[name], launches[name] = s, got
    if min(launches["paged" + suffix]["flash_attention_fwd"],
           launches["paged" + suffix]["paged_decode_fwd"]) == 0:
        raise AssertionError(f"a kernel was not launched on the paged path: {launches}")
    peak = torch.cuda.max_memory_allocated()
    for name, s in runs.items():
        log(f"  run {name}: {s['requests']} requests, {s['tokens']} tokens "
            f"({s['prompt_tokens']} prompt) in {s['wall_s']:.3f} s = {s['tok_s']:.2f} tok/s, "
            f"mean TTFT {s['mean_ttft_s'] * 1e3:.1f} ms, mean latency "
            f"{s['mean_latency_s'] * 1e3:.1f} ms, {s['prefill_steps']} prefill ticks, "
            f"{s['decode_steps']} decode steps, {s['preemptions']} preemptions, "
            f"launches {launches[name]}")
        if sp_degree > 1:
            log(f"    {name}: all-reduce {s['allreduce_bytes_per_decode_step']:.0f} B a decode "
                f"step and {s['allreduce_bytes_per_prefill_tick']:.0f} B a prefill tick, per rank "
                f"and direction (= decode_comm_cost / prefill_comm_cost x {cfg.n_layers} "
                f"layers); run total {s['allreduce_bytes_run']['fwd']:.0f} B a direction")
        if "pages" in s:
            log(f"    {name}: pages at the high water {s['pages']['high_water']} of "
                f"{s['pages']['pages_total']}"
                + (f", by stripe {s['pages']['stripes_at_high_water']}"
                   if "stripes_at_high_water" in s["pages"] else ""))
        if "tokens_equal_to_sp1_share" in s:
            log(f"    {name}: {100 * s['tokens_equal_to_sp1_share']:.1f}% of the tokens equal "
                f"phase 6's, {s['requests_equal_to_sp1']} of {s['requests']} requests whole, "
                f"first difference at token {s['mean_first_difference']:.1f} on average (not "
                "gated: the merge's bf16 rounding in another order can flip a near-tie)")
    log(f"  peak memory {peak / 2**30:.2f} GiB")
    prof = {path: profile_run(torch, dev, bundle, params, runs[path + suffix]["wall_s"],
                              paged=path == "paged")
            for path in ("paged", "dense")} if with_profile else {}
    tag = "serving_sp" if sp_degree > 1 else "serving"
    log(f"RESULT {tag} " + json.dumps({**{k: {kk: vv for kk, vv in v.items()
                                             if not isinstance(vv, dict)}
                                         for k, v in runs.items()},
                                      "peak_bytes": peak, "launches": launches,
                                      "profile_paged": prof.get("paged"),
                                      "profile_dense": prof.get("dense")}))
    return launches, outputs


# The SP-4 chains of phase 13 differ from phase 6's after a near-tie flips.
# To tell that from a fault of the SP path, every chain is fed back one
# token a step through phase 6's bundle (SP 1, the kernels): each SP-4 token
# must lie within WITNESS_GAP of that bundle's row spread (max minus mean
# logit) below its max logit.  Over a vocabulary of 151936 the max stands
# about 4.5 standard deviations above the mean and the two largest logits
# about 0.2 deviations apart, so a token drawn off a wrong attention lies a
# few deviations down, while rounding moves each logit by a small share of
# one.
WITNESS_GAP = 0.1


def teacher_forced_witness(torch, dev, outputs, max_len=2048, chunk=256):
    """Feed each SP-4 chain (``outputs``: phase 13's tokens by path, its
    prompts regenerated from serve_run's seed) through three bundles on the
    same seeded weights, the prompt in ``chunk``-token chunks, then one
    token a step: SP 1 on the
    kernels (the reference), SP 4 on the kernels (virtual ring) and SP 1 on
    the plain versions.  Gates each SP-4 token's gap below the reference's
    max logit at ``WITNESS_GAP`` of the row's spread; logs how far the SP-4
    and the plain logits lie from the reference's, as the yardstick of
    rounding."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model

    cfg = ARCHS["qwen3-1.7b"]
    bundles = {name: build_model(cfg, ParallelContext(device="cuda", **kw)) for name, kw in (
        ("sp1", {}), ("sp4", dict(sp_degree=4)), ("plain", dict(impl="torch")))}
    params = bundles["sp1"].init(0)
    res = {}
    for path, n_requests in (("paged", 16), ("dense", 4)):
        prompts = make_prompts(n_requests, 128, 1024, cfg.vocab_size)
        gaps, ratios, spreads, margins, d_sp4, d_plain, flips = ([] for _ in range(7))
        for prompt, chain in zip(prompts, outputs[path]):
            head = prompt[:-1]
            feed = [int(prompt[-1])] + chain[:-1]
            rows = {}
            for name, b in bundles.items():
                state = b.init_serve_state(1, max_len, dev)
                for i in range(0, len(head), chunk):  # the engine's chunks, the last padded
                    part = torch.zeros((1, chunk), dtype=torch.int32, device=dev)
                    n = min(chunk, len(head) - i)
                    part[0, :n] = torch.from_numpy(head[i:i + n].copy()).to(dev)
                    b.prefill_chunk(params, part, state,
                                    torch.tensor([n], device=dev, dtype=torch.int32))
                out = []
                for tok in feed:
                    logits, state = b.decode_step(params, torch.tensor([tok], device=dev), state)
                    out.append(logits[0].float())
                rows[name] = torch.stack(out)
            ref = rows["sp1"]
            top2 = ref.topk(2, dim=-1).values
            tok = torch.tensor(chain, device=dev)[:, None]
            gap = top2[:, 0] - ref.gather(1, tok)[:, 0]
            spread = top2[:, 0] - ref.mean(dim=-1)
            gaps.append(gap)
            ratios.append(gap / spread)
            spreads.append(spread)
            margins.append(top2[:, 0] - top2[:, 1])
            d_sp4.append((rows["sp4"] - ref).abs().amax(dim=-1))
            d_plain.append((rows["plain"] - ref).abs().amax(dim=-1))
            flips.append(gap > 0)
        gap, ratio, spread, margin, dsp4, dplain, flip = (torch.cat(x) for x in (
            gaps, ratios, spreads, margins, d_sp4, d_plain, flips))
        r = dict(tokens=int(gap.numel()), flips=int(flip.sum()), max_gap=float(gap.max()),
                 max_gap_over_spread=float(ratio.max()),
                 gaps_at_flips=[round(float(x), 5) for x in gap[flip].tolist()],
                 median_top2_margin=float(margin.median()),
                 median_spread=float(spread.median()),
                 sp4_vs_sp1_max_logit_diff=float(dsp4.max()),
                 sp4_vs_sp1_median_logit_diff=float(dsp4.median()),
                 plain_vs_sp1_max_logit_diff=float(dplain.max()),
                 plain_vs_sp1_median_logit_diff=float(dplain.median()))
        res[path] = r
        log(f"  witness {path}_sp4: {r['tokens']} tokens fed back through SP 1: {r['flips']} "
            f"are not SP 1's argmax, gaps below its max {r['gaps_at_flips']} (largest "
            f"{r['max_gap_over_spread']:.4f} of the row spread, median spread "
            f"{r['median_spread']:.3f}, median top-2 margin {r['median_top2_margin']:.4f}); "
            f"|SP-4 - SP-1 logits| max {r['sp4_vs_sp1_max_logit_diff']:.4f} median "
            f"{r['sp4_vs_sp1_median_logit_diff']:.4f}, |plain - SP-1| max "
            f"{r['plain_vs_sp1_max_logit_diff']:.4f} median "
            f"{r['plain_vs_sp1_median_logit_diff']:.4f}")
        if r["max_gap_over_spread"] > WITNESS_GAP:
            raise AssertionError(f"witness {path}: an SP-4 token lies "
                                 f"{r['max_gap_over_spread']:.4f} of the row spread below SP 1's "
                                 f"max logit (limit {WITNESS_GAP})")
    del bundles, params
    log("RESULT serving_sp_witness " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# phase 12: sequence-parallel serving on the kernels
# ---------------------------------------------------------------------------

SP_HEADS = (16, 8, 128)  # qwen3-1.7b attention: Hq, Hkv, D


def sp_dense_data(torch, dev, P, dtype, Smax=1024, C=64):
    """Dense cache of 4 rows at lengths 1000 (every rank holds keys), 300
    (ranks past the first hold none), 37 (rank 0 alone) and 0 (no key
    at all: its decode query at position 0 sees nothing); a C-token chunk
    after each row's length."""
    import numpy as np

    Hq, Hkv, D = SP_HEADS
    rng = np.random.default_rng(zlib.crc32(repr(("sp_dense", P)).encode()))
    lengths = np.asarray([1000, 300, 37, 0])
    B = len(lengths)
    k_pos = np.full((B, Smax), PAD_POS, np.int32)
    for b, L in enumerate(lengths):
        k_pos[b, :L] = np.arange(L)
    c_pos = (lengths[:, None] + np.arange(C)).astype(np.int32)
    arrays = dict(
        q=rng.standard_normal((B, 1, Hq, D)), k=rng.standard_normal((B, Smax, Hkv, D)),
        v=rng.standard_normal((B, Smax, Hkv, D)), k_pos=k_pos,
        q_pos=np.maximum(lengths - 1, 0)[:, None].astype(np.int32),
        cq=rng.standard_normal((B, C, Hq, D)), ck=rng.standard_normal((B, C, Hkv, D)),
        cv=rng.standard_normal((B, C, Hkv, D)), c_pos=c_pos)
    return {n: torch.from_numpy(np.ascontiguousarray(x)).to(dev).to(
        dtype if x.dtype.kind == "f" else torch.int32) for n, x in arrays.items()}


def sp_paged_data(torch, dev, P, dtype, ps=16, n_pages=128, W=64):
    """Page pool of ``n_pages`` pages striped over P ranks: row 0's table
    spans every stripe (one page from each in turn, reversed), row 1's
    pages all sit on the last stripe, row 2 holds two pages of rank 0, row 3
    none (all sentinel)."""
    import numpy as np

    Hq, Hkv, D = SP_HEADS
    rng = np.random.default_rng(zlib.crc32(repr(("sp_paged", P)).encode()))
    n_local = n_pages // P
    rows = [[(i % P) * n_local + i // P for i in range(W)][::-1],
            [n_pages - n_local + i for i in range(min(20, n_local))],
            [0, 1], []]
    lengths = np.asarray([W * ps - 5, len(rows[1]) * ps - 3, 20, 0])
    pos = np.full((n_pages, ps), PAD_POS, np.int32)
    bt = np.full((len(rows), W), n_pages, np.int32)
    for b, pages in enumerate(rows):
        bt[b, :len(pages)] = pages
        for i, pg in enumerate(pages):
            for off in range(ps):
                if i * ps + off < lengths[b]:
                    pos[pg, off] = i * ps + off
    arrays = dict(q=rng.standard_normal((len(rows), 1, Hq, D)),
                  k_pool=rng.standard_normal((n_pages, ps, Hkv, D)),
                  v_pool=rng.standard_normal((n_pages, ps, Hkv, D)), pos_pool=pos,
                  block_tables=bt, q_pos=np.maximum(lengths - 1, 0)[:, None].astype(np.int32),
                  lengths=lengths.astype(np.int32))
    return {n: torch.from_numpy(np.ascontiguousarray(x)).to(dev).to(
        dtype if x.dtype.kind == "f" else torch.int32) for n, x in arrays.items()}


def phase_sp_attention(torch, dev, ps=(2, 4, 8)):
    """``sp_decode``, ``sp_decode_paged`` and ``sp_prefill`` over P virtual
    ranks at qwen3-1.7b attention widths, f32 and bf16: on the kernels
    against the same ranks on the plain versions under phase 3's and 4's
    limits (each merged ``(out, lse)``; the row with no key exactly ``(0,
    -inf)`` before finalize, exactly 0 after), every kernel case run twice
    and bitwise equal, one launch of A (decode), C (paged) or two of A
    (prefill) a call, and the all-reduce bytes per rank and direction equal
    to ``decode_comm_cost`` / ``prefill_comm_cost``."""
    from repro_torch.core import decode as dec
    from repro_torch.core.api import ParallelContext, sp_decode, sp_decode_paged, sp_prefill
    from repro_torch.core.collectives import fold_ranks
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    Hq, Hkv, D = SP_HEADS
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = tolerances(dtype)
        tag = str(dtype)[6:]
        for P in ps:
            d = sp_dense_data(torch, dev, P, dtype)
            p = sp_paged_data(torch, dev, P, dtype)
            folded = {n: fold_ranks(d[n], P) for n in ("k", "v", "k_pos")}
            ring = ParallelContext(device="cuda", sp_degree=P).ring
            B = d["q"].shape[0]

            def calls(impl, window):
                kw = dict(ring=ring, window=window, impl=impl, return_lse=True)
                return {
                    "decode": lambda: dec.sp_decode_attention(
                        d["q"], folded["k"], folded["v"], folded["k_pos"], q_pos=d["q_pos"],
                        **kw),
                    "prefill": lambda: dec.sp_prefill_chunk_attention(
                        d["cq"], d["ck"], d["cv"], d["c_pos"], folded["k"], folded["v"],
                        folded["k_pos"], q_pos=d["c_pos"], **kw),
                    "paged": lambda: dec.sp_paged_decode_attention(
                        p["q"], p["k_pool"], p["v_pool"], p["pos_pool"], p["block_tables"],
                        p["q_pos"], lengths=p["lengths"], **kw),
                }

            per_call = {"decode": (1, 0), "prefill": (2, 0), "paged": (0, 1)}
            for window in (None, 48):
                kern, plain = calls("cuda", window), calls("torch", window)
                for name in kern:
                    a0, c0 = fa.flash_attention_fwd_cuda.launches, pa.paged_decode_fwd_cuda.launches
                    got, again = kern[name](), kern[name]()
                    ran = (fa.flash_attention_fwd_cuda.launches - a0,
                           pa.paged_decode_fwd_cuda.launches - c0)
                    if ran != tuple(2 * n for n in per_call[name]):
                        raise AssertionError(f"phase 12 {name} P={P}: launches {ran} for two "
                                             f"calls, expected {per_call[name]} a call")
                    if not all(torch.equal(x, y) for x, y in zip(got, again)):
                        raise AssertionError(f"phase 12 {name} P={P}: two runs differ")
                    label = f"SP {name} {tag} P={P} window={window} bitwise repeatable"
                    compare(label, got, plain[name](), quiet=True, **tol)
                    # row 3 holds no key: decode sees nothing; a prefill
                    # chunk there is a fresh slot's first (every rank's
                    # resident partial empty, the chunk's own keys live)
                    empty = 3
                    if name != "prefill" and not (torch.isneginf(got[1][empty]).all()
                            and torch.equal(got[0][empty], torch.zeros_like(got[0][empty]))):
                        raise AssertionError(f"{label}: the keyless row is not (0, -inf)")
                    n_cases += 1
            # the public entry points: bytes, and the keyless row exactly 0
            pctx = ParallelContext(device="cuda", sp_degree=P)
            ring2 = pctx.ring
            cost_dec = dec.decode_comm_cost(B, 1, Hq, Hkv, D, P)
            cost_pre = dec.prefill_comm_cost(B, d["cq"].shape[1], Hq, Hkv, D, P)
            for name, fn, cost in (
                    ("decode", lambda: sp_decode(d["q"], folded["k"], folded["v"],
                                                 folded["k_pos"], d["q_pos"], pctx=pctx),
                     cost_dec),
                    ("paged", lambda: sp_decode_paged(
                        p["q"], p["k_pool"], p["v_pool"], p["pos_pool"], p["block_tables"],
                        p["q_pos"], p["lengths"], pctx=pctx), cost_dec),
                    ("prefill", lambda: sp_prefill(d["cq"], d["ck"], d["cv"], d["c_pos"],
                                                   folded["k"], folded["v"], folded["k_pos"],
                                                   d["c_pos"], pctx=pctx), cost_pre)):
                ring2.reset_counts()
                out = fn()
                if ring2.link_bytes != {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}:
                    raise AssertionError(f"phase 12 {name} {tag} P={P}: bytes "
                                         f"{ring2.link_bytes}, cost model {cost}")
                if name != "prefill" and not torch.equal(out[3], torch.zeros_like(out[3])):
                    raise AssertionError(f"phase 12 {name} {tag} P={P}: keyless row not 0")
            log(f"  ok SP {tag} P={P}: decode, prefill and paged decode (window None and 48) on "
                f"the kernels within phase 3/4 limits of the plain ranks, bitwise repeatable, "
                f"keyless row (0, -inf); all-reduce bytes a rank and direction "
                f"{cost_dec.fwd_bytes:.0f} (decode, paged) and {cost_pre.fwd_bytes:.0f} "
                f"(prefill) = the cost models")
    log(f"  phase 12: {n_cases} kernel cases passed")


def sp_main_data(torch, dev, P=4, Smax=2048, ps=16, n_pages=1024, C=256):
    """Phase 13's attention inputs at P = 4 in bf16, laid out as its engines
    lay them out.  Decode lengths are drawn from ``Smax/16 + 1`` to
    ``Smax/2 + 32`` (129-1056: prompts of 128-1024 tokens plus up to 32 new
    ones); a prefill chunk's resident
    length is the multiple of the chunk size C below, row 0's 0 (a fresh
    slot: no resident key on any rank).  Dense slab: 4 slots of ``Smax``
    keys, rank-major (16 rows of 512 keys).  Paged: 8 slots with block
    tables of ``Smax / ps`` entries into a pool of ``n_pages`` pages; row
    1 holds the lowest page ids (all on stripe 0, as the allocator hands
    them out first), the other rows pages drawn from every stripe; the
    chunk's resident view is gathered rank-major (32 rows of ``Smax``
    keys, each rank's own pages live) as ``lm_prefill_chunk_paged`` does."""
    import numpy as np

    from repro_torch.core.collectives import fold_ranks
    from repro_torch.serving.kv_cache import (
        gather_pages,
        gather_positions,
        stripe_view,
        view_indices,
    )

    Hq, Hkv, D = SP_HEADS
    W = Smax // ps
    rng = np.random.default_rng(zlib.crc32(b"sp_main"))
    gen = torch.Generator(device=dev).manual_seed(17)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def ints(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    def lengths(B):
        dec = rng.integers(Smax // 16 + 1, Smax // 2 + 33, B)
        pre = (dec - 1) // C * C
        pre[0] = 0
        return dec, pre

    dec, pre = lengths(4)
    ar = np.arange(Smax)[None]
    dense = dict(q=rnd(4, 1, Hq, D), q_pos=ints(dec[:, None] - 1),
                 k=fold_ranks(rnd(4, Smax, Hkv, D), P), v=fold_ranks(rnd(4, Smax, Hkv, D), P),
                 k_pos=fold_ranks(ints(np.where(ar < dec[:, None], ar, PAD_POS)), P),
                 pre_pos=fold_ranks(ints(np.where(ar < pre[:, None], ar, PAD_POS)), P),
                 cq=rnd(4, C, Hq, D), ck=rnd(4, C, Hkv, D), cv=rnd(4, C, Hkv, D),
                 c_pos=ints(pre[:, None] + np.arange(C)))
    dec, pre = lengths(8)
    used = -(-dec // ps)
    free = iter(rng.permutation(np.arange(used[1], n_pages)).tolist())
    bt = np.full((8, W), n_pages, np.int32)
    pos = np.full((n_pages, ps), PAD_POS, np.int32)
    for b in range(8):
        pages = list(range(used[1])) if b == 1 else [next(free) for _ in range(used[b])]
        bt[b, :used[b]] = pages
        for i, pg in enumerate(pages):
            pos[pg] = np.where(i * ps + np.arange(ps) < dec[b], i * ps + np.arange(ps), PAD_POS)
    k_pool, v_pool, pos_pool, tables = (rnd(n_pages, ps, Hkv, D), rnd(n_pages, ps, Hkv, D),
                                        ints(pos), ints(bt))
    view = stripe_view(view_indices(tables, ps, lengths=ints(pre)), n_pages, ps, P, None)
    paged = dict(q=rnd(8, 1, Hq, D), q_pos=ints(dec[:, None] - 1), k_pool=k_pool,
                 v_pool=v_pool, pos_pool=pos_pool, block_tables=tables, lengths=ints(dec),
                 k_view=gather_pages(k_pool, view), v_view=gather_pages(v_pool, view),
                 view_pos=gather_positions(pos_pool, view), cq=rnd(8, C, Hq, D),
                 ck=rnd(8, C, Hkv, D), cv=rnd(8, C, Hkv, D),
                 c_pos=ints(pre[:, None] + np.arange(C)))
    return dense, paged


def phase_sp_main_shapes(torch, dev, P=4, **sizes):
    """The SP serving functions at the shapes phase 13 gives kernels A and C
    (:func:`sp_main_data`), bf16, on the kernels against the same ranks on
    the plain versions under phase 3's and 4's limits, every call run twice
    and bitwise equal, with its launches checked.  Then each kernel call
    these functions make, on the inputs they give it: the wrapper against
    its plain version (the same limits) and timed beside the plain version,
    the PyTorch library call (A: ``scaled_dot_product_attention`` with the
    same mask, GQA heads repeated; C: none) and the bound of this data's
    work (``sizes`` shrink :func:`sp_main_data` for a rehearsal off the
    card).  Returns the timing rows by call."""
    import torch.nn.functional as F

    from repro_torch.core import decode as dec
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ops import pick_block
    from repro_torch.kernels.ref import visibility_mask

    d, p = sp_main_data(torch, dev, P, **sizes)
    ring = ParallelContext(device="cuda", sp_degree=P).ring
    tol = tolerances(torch.bfloat16)
    calls = {
        "dense decode": ((1, 0), lambda impl: dec.sp_decode_attention(
            d["q"], d["k"], d["v"], d["k_pos"], q_pos=d["q_pos"], ring=ring, impl=impl,
            return_lse=True)),
        "dense prefill": ((2, 0), lambda impl: dec.sp_prefill_chunk_attention(
            d["cq"], d["ck"], d["cv"], d["c_pos"], d["k"], d["v"], d["pre_pos"],
            q_pos=d["c_pos"], ring=ring, impl=impl, return_lse=True)),
        "paged prefill": ((2, 0), lambda impl: dec.sp_prefill_chunk_attention(
            p["cq"], p["ck"], p["cv"], p["c_pos"], p["k_view"], p["v_view"], p["view_pos"],
            q_pos=p["c_pos"], ring=ring, impl=impl, return_lse=True)),
        "paged decode": ((0, 1), lambda impl: dec.sp_paged_decode_attention(
            p["q"], p["k_pool"], p["v_pool"], p["pos_pool"], p["block_tables"], p["q_pos"],
            ring=ring, lengths=p["lengths"], impl=impl, return_lse=True)),
    }
    for name, (per_call, fn) in calls.items():
        a0, c0 = fa.flash_attention_fwd_cuda.launches, pa.paged_decode_fwd_cuda.launches
        got, again = fn("cuda"), fn("cuda")
        ran = (fa.flash_attention_fwd_cuda.launches - a0, pa.paged_decode_fwd_cuda.launches - c0)
        if ran != tuple(2 * n for n in per_call):
            raise AssertionError(f"phase 12 {name} at phase 13's shapes: launches {ran} for two "
                                 f"calls, expected {per_call} a call")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"phase 12 {name} at phase 13's shapes: two runs differ")
        compare(f"SP bf16 P={P} {name} at phase 13's shapes, bitwise repeatable", got,
                fn("torch"), **tol)

    scale = 1.0 / SP_HEADS[2] ** 0.5
    rep = ring.replicate
    a_calls = {  # the kernel-A calls of phase 13, each on its own inputs
        "paged_prefill_resident": (rep(p["cq"]), p["k_view"], p["v_view"], rep(p["c_pos"]),
                                   p["view_pos"]),
        "paged_prefill_chunk_local": (p["cq"], p["ck"], p["cv"], p["c_pos"], p["c_pos"]),
        "dense_prefill_resident": (rep(d["cq"]), d["k"], d["v"], rep(d["c_pos"]),
                                   d["pre_pos"]),
        "dense_decode": (rep(d["q"]), d["k"], d["v"], rep(d["q_pos"]), d["k_pos"]),
    }
    rows = {}
    for name, (q, k, v, qp, kp) in a_calls.items():
        Hq, Hkv = q.shape[2], k.shape[2]
        kern = lambda: fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True,  # noqa: E731
                                                   window=None, scale=scale)
        plain = lambda: fa.flash_attention_fwd_torch(  # noqa: E731
            q, k, v, qp, kp, causal=True, window=None, scale=scale,
            block_k=pick_block(k.shape[1], 512))
        inst = fa.flash_fwd_instance(q.dtype, q.shape[1], q.shape[-1])
        err = compare(f"A bf16 [{inst}] phase 13's {name} call", kern(), plain(), **tol)
        mask = visibility_mask(qp, kp, causal=True, window=None)[:, None]
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2) for x in (k, v))
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
        ms, plain_ms, lib_ms = device_ms(kern), device_ms(plain, iters=3), device_ms(lib)
        bms, by = bound(*flash_bytes_flops(q, k, qp, kp, True, None), "bfloat16")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                          bound_by=by, max_abs_err=err, instance=inst,
                          timing="device time (torch.profiler)",
                          shape=f"B={q.shape[0]} Sq={q.shape[1]} Sk={k.shape[1]} Hq={Hq} "
                                f"Hkv={Hkv} D={q.shape[3]} bf16 (P={P} folded)")
        del mask, qt, kt, vt
    # kernel C: every rank's rows of the table keep only its stripe
    bt = dec.folded_stripe_tables(p["block_tables"], P, p["k_pool"].shape[0])
    q, qp, lens = rep(p["q"]), rep(p["q_pos"]), rep(p["lengths"])
    kern = lambda: pa.paged_decode_fwd_cuda(q, p["k_pool"], p["v_pool"],  # noqa: E731
                                            p["pos_pool"], bt, qp, window=None, scale=scale)
    plain = lambda: pa.paged_decode_fwd_torch(  # noqa: E731
        q, p["k_pool"], p["v_pool"], p["pos_pool"], bt, qp, lengths=lens, window=None,
        scale=scale, block_k=512)
    err = compare(f"C bf16 phase 13's paged decode call (P={P} folded)", kern(), plain(), **tol)
    ms, plain_ms = device_ms(kern), device_ms(plain, iters=5)
    n_pages, ps, Hkv, D = p["k_pool"].shape
    live = int((bt < n_pages).sum())
    nbytes = (live * ps * Hkv * D * 2 * 2 + live * ps * 4 + bt.numel() * 4 + 2 * q.numel() * 2
              + q.shape[0] * q.shape[2] * 4)
    bms, by = bound(nbytes, 4.0 * D * q.shape[2] * int(p["lengths"].sum()), "bfloat16")
    rows["paged_decode"] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by, max_abs_err=err,
        timing="device time (torch.profiler)",
        shape=f"B={q.shape[0]} ps={ps} Hq={q.shape[2]} Hkv={Hkv} D={D} W={bt.shape[1]} "
              f"pool={n_pages} live entries={live} bf16 (P={P} folded)")
    for name, r in rows.items():
        log(f"  phase 13's {name} call: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            + (f"sdpa {r['library_ms']:.4f} ms, " if r["library_ms"] is not None else "")
            + f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) at {r['shape']}")
    return rows


# ---------------------------------------------------------------------------
# phase 7: kernels B1 and B2
# ---------------------------------------------------------------------------

BWD_CASES = [
    # id, (B, Sq, Sk, Hq, Hkv, D), causal, layout, window: the JAX package's
    # backward cases (tests/test_kernels.py::BWD_CASES), then D=128 GQA, a
    # ragged edge (no multiple of the kernels' 32-row tiles, Sq != Sk) and
    # dead rows (queries before every key; a batch row of padding keys)
    ("causal", (1, 128, 128, 2, 2, 32), True, "contig", None),
    ("noncausal", (1, 128, 128, 2, 2, 32), False, "contig", None),
    ("gqa", (2, 128, 128, 4, 2, 32), True, "contig", None),
    ("mqa", (1, 128, 128, 4, 1, 64), True, "contig", None),
    ("zigzag", (1, 256, 256, 2, 2, 32), True, "zigzag", None),
    ("zigzag_gqa", (1, 256, 256, 4, 2, 32), True, "zigzag", None),
    ("window", (1, 256, 256, 2, 2, 32), True, "contig", 64),
    ("gqa_d128", (2, 256, 256, 16, 8, 128), True, "contig", None),
    ("ragged", (2, 37, 45, 4, 2, 32), True, "offset", None),
    ("dead_rows", (2, 256, 256, 2, 2, 64), True, "dead", None),
]
# bf16 cases on the wgmma instances (D 64/128): the bf16 D 64/128 rows of
# BWD_CASES, then zigzag, window and ragged edges at both widths
BWD_BF16_CASES = [
    ("mqa", (1, 128, 128, 4, 1, 64), True, "contig", None),
    ("gqa_d128", (2, 256, 256, 16, 8, 128), True, "contig", None),
    ("dead_rows", (2, 256, 256, 2, 2, 64), True, "dead", None),
] + [case for D in (64, 128) for case in (
    ("zigzag", (1, 256, 256, 4, 2, D), True, "zigzag", None),
    ("window", (1, 256, 256, 2, 2, D), True, "contig", 64),
    ("ragged", (2, 37, 45, 4, 2, D), True, "offset", None),
    ("ragged", (2, 165, 173, 4, 2, D), True, "offset", None),
)]
TRAIN_SHAPE = dict(B=2, S=4096, Hq=16, Hkv=8, D=128)  # qwen3-1.7b, batch 2 x seq 4096
# The wgmma instances round P and dS to bf16 (2^-9 relative per term) as
# the operands of the dq, dk and dv products, where the plain backward
# multiplies float32 values.  Each gradient element is a sum of such terms
# of random sign, so its error scales with the size of its row's terms, not
# with the element itself: a limit in |plain| or in absolute units is either
# loose for rows with small gradients (long causal rows, late keys) or tight
# for large ones.  The limit is therefore per row of D values: |err| <=
# row * rms(plain row), and per tensor ||err|| <= l2 * ||plain||.  On the
# card the worst element read 1.23e-2 of its row's RMS at the training
# shape (1.19e-2 on the cases above), and the worst tensor 1.65e-3 relative
# L2 there (1.76e-3 above) (PERF.md, section 6); a CPU emulation of the
# rounding against the JAX backward (tests/test_torch_flash_bwd_numerics.py)
# passes the same limit.  It keeps 2.4x and 2.8x above those readings and
# stays 20x below a typical element (0.67 of its row's RMS).  A row whose plain gradient is all zero
# must be exactly zero.  The float32 limits stay 1e-4.
BWD_BF16_LIMIT = dict(row=3e-2, l2=5e-3)


def zigzag_order(S, P):
    half = S // (2 * P)
    zz = []
    for j in range(P):
        zz += list(range(j * half, (j + 1) * half))
        zz += list(range((2 * P - 1 - j) * half, (2 * P - j) * half))
    return zz


def bwd_positions(torch, dev, B, Sq, Sk, layout):
    qp = torch.arange(Sq, device=dev, dtype=torch.int32)
    kp = torch.arange(Sk, device=dev, dtype=torch.int32)
    if layout == "zigzag":
        qp = kp = torch.tensor(zigzag_order(Sq, 4), device=dev, dtype=torch.int32)
    elif layout == "offset":
        qp = qp + 8
    qp = qp.expand(B, Sq).contiguous()
    kp = kp.expand(B, Sk).contiguous()
    if layout == "dead":
        qp[0, :16] = -1
        kp[1] = PAD_POS
    return qp, kp


def bwd_bytes_flops(q, k, q_pos, k_pos, causal, window, flops_per_pair_dim, out_tensors):
    """Inputs read once (q, dout, live K/V, lse/delta/dlse, positions), the
    float32 gradients written once, and ``flops_per_pair_dim * D`` flops per
    visible (query, key, head): 6 for B1 (s, dp, dq), 8 for B2 (s, dp, dk, dv)."""
    from repro_torch.kernels.ref import visibility_mask

    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    live_keys = int((k_pos < PAD_POS // 2).sum())
    e = q.element_size()
    nbytes = (2 * q.numel() * e + 2 * live_keys * Hkv * D * e + 3 * B * Sq * Hq * 4
              + (q_pos.numel() + k_pos.numel()) * 4 + sum(t.numel() * 4 for t in out_tensors))
    pairs = int(visibility_mask(q_pos, k_pos, causal=causal, window=window).sum())
    return nbytes, float(flops_per_pair_dim) * D * Hq * pairs


def run_bwd(torch, q, k, v, qp, kp, dout, dlse, causal, window, out=None, lse=None):
    """B1 and B2 twice each (bitwise equal or raise) and the plain backward,
    on the same inputs; ``out``/``lse`` default to the plain forward's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import pick_block

    scale = 1.0 / q.shape[-1] ** 0.5
    Sq, Sk = q.shape[1], k.shape[1]
    if out is None:
        out, lse = fa.flash_attention_fwd_torch(q, k, v, qp, kp, causal=causal, window=window,
                                                scale=scale, block_k=pick_block(Sk, 512))
        lse = lse.contiguous()  # the plain version returns a transposed view
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    args = (q, k, v, qp, kp, dout, lse, delta, dlse)
    kw = dict(causal=causal, window=window, scale=scale)

    def kernels():
        return (fa.flash_attention_bwd_dq_cuda(*args, **kw),
                *fa.flash_attention_bwd_dkv_cuda(*args, **kw))

    got, again = kernels(), kernels()
    for name, a, b in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: two runs on the same inputs differ")
    want = fa.flash_attention_bwd_torch(q, k, v, qp, kp, out, lse, dout, dlse, causal=causal,
                                        window=window, scale=scale,
                                        block_q=pick_block(Sq, 512), block_k=pick_block(Sk, 512))
    return got, want, args, kw


def compare_grads(torch, name, got, want, atol=0.0, rtol=0.0, row=0.0, l2=None, dead=None,
                  elementwise=True, quiet=False):
    """Raise unless each of dq/dk/dv is finite and within ``atol + rtol *
    |plain| + row * rms(plain row)`` of the plain version elementwise (a row
    is the D values of one (batch, position, head); ``elementwise=False``
    skips this), ``||err|| <= l2 * ||plain||`` when ``l2`` is given, and,
    given ``dead = (rows, keys)``, the dq rows that see no key and the dk/dv
    rows of keys that no query sees are exactly 0.  Returns the largest
    |error| and the readings ``(max |err|/rms(row), ||err||/||plain||)`` of
    each gradient (logged unless ``quiet``)."""
    worst, readings, pairs = 0.0, [], []
    for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {g_name}: not finite")
        err = (g - w).abs()
        rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
        rel_row = float((err / rms).nan_to_num(0.0, posinf=float("inf")).max())
        rel_l2 = float(err.norm() / w.norm())
        pairs.append((rel_row, rel_l2))
        if elementwise and not torch.all(err <= atol + rtol * w.abs() + row * rms):
            raise AssertionError(f"{name} {g_name}: max |err| {float(err.max()):.3e}, "
                                 f"max |err|/rms(row) {rel_row:.3e}")
        if l2 is not None and not rel_l2 <= l2:
            raise AssertionError(f"{name} {g_name}: ||err||/||plain|| {rel_l2:.3e} > {l2}")
        worst = max(worst, float(err.max()))
        readings.append(f"{g_name} {rel_row:.2e}/{rel_l2:.2e}")
    n_dead = ""
    if dead is not None:
        rows, keys = dead
        for g_name, g, m in (("dq", got[0], rows), ("dk", got[1], keys), ("dv", got[2], keys)):
            if g[m].count_nonzero():
                raise AssertionError(f"{name} {g_name}: gradients of rows that see no key, or "
                                     "of keys that no query sees, are not exactly 0")
        n_dead = f", {int(rows.sum())} dead (row, head) and {int(keys.sum())} unseen keys exactly 0"
    if not quiet:
        log(f"  ok {name}: max|grad err| {worst:.3e} (max |err|/rms(row) / ||err||/||plain||: "
            f"{', '.join(readings)}){n_dead}, a second run bitwise equal")
    return worst, pairs


def dead_masks(torch, lse, qp, kp, causal, window):
    """``(rows, keys)``: the (batch, query, head) rows whose lse is -inf,
    and the (batch, key) rows that no query of the batch row sees."""
    from repro_torch.kernels.ref import visibility_mask

    seen = visibility_mask(qp, kp, causal=causal, window=window).any(dim=1)
    return torch.isneginf(lse), ~seen


def phase_bwd(torch, dev, train_shape=TRAIN_SHAPE):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import pick_block

    # each line names the instance the built library picks; the host's copy
    # of that rule (used where no library is built) must agree with it
    for dtype in (torch.float32, torch.bfloat16):
        for D in (32, 64, 128):
            built, host = fa.flash_bwd_instance_built(dtype, D), fa.flash_bwd_instance(dtype, D)
            if built != host:
                raise AssertionError(f"B1/B2 {dtype} D={D}: the library takes the {built} "
                                     f"instance, flash_bwd_instance says {host}")
    gen = torch.Generator(device=dev).manual_seed(2)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # float32: both sides sum float32 products of the same inputs, only in
    # another order, so 1e-4 absolute plus 1e-4 relative holds.
    for case_id, (B, Sq, Sk, Hq, Hkv, D), causal, layout, window in BWD_CASES:
        qp, kp = bwd_positions(torch, dev, B, Sq, Sk, layout)
        q, dout = rnd((B, Sq, Hq, D)), rnd((B, Sq, Hq, D))
        k, v = rnd((B, Sk, Hkv, D)), rnd((B, Sk, Hkv, D))
        dlse = rnd((B, Sq, Hq))  # the TokenRing partial's lse cotangent
        got, want, args, _ = run_bwd(torch, q, k, v, qp, kp, dout, dlse, causal, window)
        inst = fa.flash_bwd_instance_built(q.dtype, D)
        compare_grads(torch, f"B1/B2 f32 {case_id} {(B, Sq, Sk, Hq, Hkv, D)} [{inst}]", got,
                      want, atol=1e-4, rtol=1e-4,
                      dead=dead_masks(torch, args[6], qp, kp, causal, window))

    B, S, Hq, Hkv, D = (train_shape[x] for x in ("B", "S", "Hq", "Hkv", "D"))
    bf = torch.bfloat16
    q, dout = rnd((B, S, Hq, D), bf), rnd((B, S, Hq, D), bf)
    k, v = rnd((B, S, Hkv, D), bf), rnd((B, S, Hkv, D), bf)
    dlse = rnd((B, S, Hq))
    qp = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    scale = 1.0 / D ** 0.5

    def fwd():
        return fa.flash_attention_fwd_cuda(q, k, v, qp, qp, causal=True, window=None,
                                           scale=scale)

    out, lse = fwd()
    blk = pick_block(S, 512)  # the plain versions' tile
    a_err = compare(f"A bf16 training shape [{fa.flash_fwd_instance(bf, S, D)}]", (out, lse),
                    fa.flash_attention_fwd_torch(q, k, v, qp, qp, causal=True, window=None,
                                                 scale=scale, block_k=blk),
                    **tolerances(bf))
    # bf16 inputs at the training shape, causal; out/lse from kernel A, as
    # on the training path; held to the bf16 limit (BWD_BF16_LIMIT).
    got, want, args, kw = run_bwd(torch, q, k, v, qp, qp, dout, dlse, True, None, out, lse)
    shape = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} bf16 causal"
    inst = fa.flash_bwd_instance_built(bf, D)
    err, _ = compare_grads(torch, f"B1/B2 bf16 training shape {shape} [{inst}]", got, want,
                           dead=dead_masks(torch, lse, qp, qp, True, None), **BWD_BF16_LIMIT)

    ms_dq = time_ms(lambda: fa.flash_attention_bwd_dq_cuda(*args, **kw), iters=3, reps=3)
    ms_dkv = time_ms(lambda: fa.flash_attention_bwd_dkv_cuda(*args, **kw), iters=3, reps=3)
    plain_bwd_ms = time_ms(lambda: fa.flash_attention_bwd_torch(
        q, k, v, qp, qp, out, lse, dout, dlse, causal=True, window=None, scale=scale,
        block_q=blk, block_k=blk), iters=1, reps=3)
    ms_a = time_ms(fwd, iters=3, reps=3)
    plain_fwd_ms = time_ms(lambda: fa.flash_attention_fwd_torch(
        q, k, v, qp, qp, causal=True, window=None, scale=scale, block_k=blk), iters=1, reps=3)
    # yardsticks only: SDPA gives no lse, so its backward has no dlse term
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib_fwd_ms = time_ms(sdpa, iters=5)
    o_t, do_t = sdpa(), dout.transpose(1, 2)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(o_t, (qt, kt, vt), do_t,
                                                     retain_graph=True), iters=5)
    rows = {}
    for name, ms, per_pair, outs in (("dq", ms_dq, 6, got[:1]), ("dkv", ms_dkv, 8, got[1:])):
        nbytes, flops = bwd_bytes_flops(q, k, qp, qp, True, None, per_pair, outs)
        bms, by = bound(nbytes, flops, "bfloat16")
        rows[name] = dict(ms=ms, plain_ms=plain_bwd_ms, library_ms=lib_bwd_ms, bound_ms=bms,
                          bound_by=by, max_abs_err=err, instance=inst, shape=shape,
                          plain_and_library_compute="dq, dk and dv in one call")
        log(f"  B {name} [{inst}]: kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{flops / ms / 1e9:.2f} TFLOP/s")
    nbytes, flops = flash_bytes_flops(q, k, qp, qp, True, None)
    bms, by = bound(nbytes, flops, "bfloat16")
    inst = fa.flash_fwd_instance(q.dtype, S, D)
    rows["fwd"] = dict(ms=ms_a, plain_ms=plain_fwd_ms, library_ms=lib_fwd_ms, bound_ms=bms,
                       bound_by=by, max_abs_err=a_err, instance=inst, shape=shape)
    log(f"  training shape: A [{inst}] {ms_a:.3f} ms (plain {plain_fwd_ms:.3f}, sdpa {lib_fwd_ms:.3f}, "
        f"bound {bms:.4f} {by}, {flops / ms_a / 1e9:.2f} TFLOP/s); backward plain "
        f"{plain_bwd_ms:.3f} ms, sdpa backward {lib_bwd_ms:.3f} ms")
    phase_bwd_bf16(torch, dev)
    return rows


def phase_bwd_bf16(torch, dev, cases=BWD_BF16_CASES):
    """B1 and B2 in bf16 against the plain backward (inputs widened from
    the same bf16 values) on the wgmma instances' edge cases, each run twice
    and required bitwise equal.  A generator of their own keeps the other
    cases' data as it was."""
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16

    def rnd(shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for case_id, (B, Sq, Sk, Hq, Hkv, D), causal, layout, window in cases:
        qp, kp = bwd_positions(torch, dev, B, Sq, Sk, layout)
        q, dout = rnd((B, Sq, Hq, D)), rnd((B, Sq, Hq, D))
        k, v = rnd((B, Sk, Hkv, D)), rnd((B, Sk, Hkv, D))
        dlse = rnd((B, Sq, Hq), torch.float32)
        got, want, args, _ = run_bwd(torch, q, k, v, qp, kp, dout, dlse, causal, window)
        inst = fa.flash_bwd_instance_built(bf, D)
        label = f"{case_id} window={window}" if window else case_id
        compare_grads(torch, f"B1/B2 bf16 {label} {(B, Sq, Sk, Hq, Hkv, D)} [{inst}]", got,
                      want, dead=dead_masks(torch, args[6], qp, kp, causal, window),
                      **BWD_BF16_LIMIT)


# ---------------------------------------------------------------------------
# phases 8 and 9: training
# ---------------------------------------------------------------------------


def named_leaves(tree, prefix=""):
    """``(name, tensor)`` in ``optim.adamw.tree_leaves`` order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in named_leaves(tree[key], f"{prefix}.{key}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, sub in enumerate(tree) for x in named_leaves(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


TRAIN_KERNELS = {"flash_attention_fwd": "flash_attention_fwd_cuda",
                 "flash_attention_bwd_dq": "flash_attention_bwd_dq_cuda",
                 "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_cuda"}


def launch_counts():
    from repro_torch.kernels import flash_attention as fa

    return {name: getattr(fa, fn).launches for name, fn in TRAIN_KERNELS.items()}


def reset_launch_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    for fn in TRAIN_KERNELS.values():
        getattr(fa, fn).launches = 0
    pa.paged_decode_fwd_cuda.launches = 0


def train_launches_per_step(cfg, computes: int = 1):
    """remat "full" runs A in the forward and again in each block's
    recompute; B1 and B2 once per layer.  ``computes``: flash calls of one
    attention layer (the ring schedule's Compute count; 1 at SP 1)."""
    L = cfg.n_layers * computes
    return {"flash_attention_fwd": (2 if cfg.remat == "full" else 1) * L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L}


def kernels_vs_plain_step(torch, dev, cfg, B, S, **pctx_kw):
    """One loss-and-gradient step of ``cfg`` on the kernels and one on the
    plain path, from the same parameters and batch (``pctx_kw``: the SP
    degree and strategy of both).  Returns both losses, gradients and
    parameters, and the kernel launches of the first."""
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime.trainer import batch_to_device

    kern = build_model(cfg, ParallelContext(device="cuda", **pctx_kw))
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda", **pctx_kw))
    P = kern.pctx.sp_degree
    computes = ring_computes(kern.pctx.strategy, P) if P > 1 else 1
    p_kern = kern.init(0, training=True)
    p_plain = tree_map(lambda t: t.detach().clone(), p_kern)
    batch = batch_to_device(next(SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1, layout=cfg.layout,
        sp_degree=P))), dev)
    before = launch_counts()
    (l_kern, _), g_kern = value_and_grad(kern.loss, p_kern, batch)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    if ran != train_launches_per_step(cfg, computes):
        raise AssertionError(f"phase 8: kernel launches {ran}, expected "
                             f"{train_launches_per_step(cfg, computes)}")
    before = launch_counts()
    (l_plain, _), g_plain = value_and_grad(plain.loss, p_plain, batch)
    if launch_counts() != before:
        raise AssertionError("phase 8: the plain path launched a kernel")
    return l_kern, l_plain, g_kern, g_plain, p_kern, p_plain, ran


def worst_leaf(torch, g_kern, g_plain, limit):
    """Largest ``max|kernel - plain| / max|plain|`` over the gradient leaves;
    raises if a leaf is not finite or is above ``limit``."""
    worst = 0.0
    for (name, a), (_, b) in zip(named_leaves(g_kern), named_leaves(g_plain)):
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if not (torch.isfinite(a).all() and rel <= limit):
            raise AssertionError(f"phase 8: gradient {name} off by {rel:.3e} of its max")
        worst = max(worst, rel)
    return worst


def phase_train_checked(torch, dev, cfg=None, B=2, S=512, label="phase 8", **pctx_kw):
    """One step at qwen3-1.7b widths, 2 layers, float32: kernels vs plain
    (``pctx_kw``: the SP degree and strategy of both sides)."""
    from repro_torch.configs import ARCHS
    from repro_torch.optim.adamw import adamw_init, adamw_update

    cfg = cfg or ARCHS["qwen3-1.7b"].with_(n_layers=2, dtype="float32")
    l_kern, l_plain, g_kern, g_plain, p_kern, p_plain, ran = kernels_vs_plain_step(
        torch, dev, cfg, B, S, **pctx_kw)
    # Everything but attention runs the same float32 ops on both sides, and
    # attention differs only in the order of float32 sums: the loss is held
    # to 1e-5 relative, each gradient leaf to 1e-4 of its largest |value|.
    l_err = abs(float(l_kern) - float(l_plain))
    if not (math.isfinite(float(l_kern)) and l_err <= 1e-5 * abs(float(l_plain))):
        raise AssertionError(f"phase 8: loss {float(l_kern)} vs plain {float(l_plain)}")
    worst = worst_leaf(torch, g_kern, g_plain, 1e-4)
    # One AdamW step each.  A first Adam step moves each element by about
    # lr * sign(gradient), so an element whose gradient is within the error
    # above of 0 may step up to 2*lr apart on the two sides: every element is
    # held to 2*lr.  An element whose gradient is at least 1e-2 of its leaf's
    # largest (100x the gradient limit, so its sign is certain) is held to
    # 0.05*lr.
    lr = 1e-5
    adamw_update(g_kern, adamw_init(p_kern), p_kern, lr=lr)
    adamw_update(g_plain, adamw_init(p_plain), p_plain, lr=lr)
    p_err = sure_err = 0.0
    n_apart = 0
    for (name, a), (_, b), (_, g) in zip(named_leaves(p_kern), named_leaves(p_plain),
                                         named_leaves(g_plain)):
        d = (a.detach() - b.detach()).abs()
        sure = g.abs() >= 1e-2 * g.abs().max()
        d_sure = float(d[sure].max()) if sure.any() else 0.0
        if float(d.max()) > 2 * lr or d_sure > 0.05 * lr:
            raise AssertionError(f"phase 8: parameter {name} after AdamW off by "
                                 f"{float(d.max()):.3e} ({d_sure:.3e} where the gradient is sure)")
        p_err, sure_err = max(p_err, float(d.max())), max(sure_err, d_sure)
        n_apart += int((d > 0.05 * lr).sum())
    log(f"  ok {label}: loss {float(l_kern):.6f} vs plain {float(l_plain):.6f} (|err| "
        f"{l_err:.2e}); worst gradient leaf off by {worst:.2e} of its max; parameters after "
        f"AdamW (lr {lr}) within {p_err:.2e} ({sure_err:.2e} where the gradient is sure), "
        f"{n_apart} elements apart by more than 0.05*lr; launches {ran}")


def phase_train_checked_bf16(torch, dev, cfg=None, B=2, S=512):
    """One step at qwen3-1.7b widths, 2 layers, bf16 compute (float32
    parameters): kernel A's wgmma instance feeds B1/B2 on the training path;
    loss and gradients against the plain path."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as fa

    cfg = cfg or ARCHS["qwen3-1.7b"].with_(n_layers=2)
    inst = fa.flash_fwd_instance(torch.bfloat16, S, cfg.d_head)
    l_kern, l_plain, g_kern, g_plain, _, _, ran = kernels_vs_plain_step(torch, dev, cfg, B, S)
    # The two sides differ only in attention's forward: the wgmma instance
    # rounds P to bf16 for its P V product (2^-9 relative per term) where the
    # plain version multiplies float32 P, and sums in another order; both
    # round out to bf16, so out can land one bf16 step (2^-8 relative)
    # apart.  Every product around attention runs in bf16 on both sides and
    # carries such a flip on into the gradients, and the q/k-norm scales'
    # gradients (sums over every token and head) lose most to cancellation.
    # A CPU emulation of the instance's rounding
    # (tests/test_torch_flash_fwd_numerics.py) in this 2-layer step at d 512
    # and d 1024 put the loss 4e-6 and 1e-5 apart (relative) and the worst
    # leaf 1.0e-2 and 1.5e-2 of its largest value.  Limits: loss 1e-4
    # relative, every gradient leaf 5e-2 of its largest |value|.
    l_err = abs(float(l_kern) - float(l_plain))
    if not (math.isfinite(float(l_kern)) and l_err <= 1e-4 * abs(float(l_plain))):
        raise AssertionError(f"phase 8 bf16: loss {float(l_kern)} vs plain {float(l_plain)}")
    worst = worst_leaf(torch, g_kern, g_plain, 5e-2)
    log(f"  ok phase 8 bf16 [{inst}]: loss {float(l_kern):.6f} vs plain {float(l_plain):.6f} "
        f"(|err| {l_err:.2e}); worst gradient leaf off by {worst:.2e} of its max; "
        f"launches {ran}")


def profile_step(torch, fn, wall_s):
    """``fn`` once under torch.profiler: device busy share and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    rows = device_rows(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"  profiled step: wall {prof_wall:.3f} s, device busy {busy_s:.3f} s "
        f"({100 * busy_s / prof_wall:.1f}%); against the unprofiled step {wall_s:.3f} s: busy "
        f"{100 * busy_s / wall_s:.1f}%, idle {100 * (1 - busy_s / wall_s):.1f}%")
    for us, count, key in rows[:12]:
        log(f"    {us / 1e3:10.2f} ms {100 * us / 1e6 / busy_s:5.1f}% x{count:6d} {key[:90]}")
    return {"wall_s": prof_wall, "device_busy_s": busy_s, "unprofiled_wall_s": wall_s,
            "top": [{"ms": us / 1e3, "count": c, "kernel": k[:120]} for us, c, k in rows[:12]],
            "port_kernels": port_kernel_rows(rows, busy_s)}


def phase_train_full(torch, dev, with_profile, cfg=None, B=2, S=4096, steps=3):
    """The training path: qwen3-1.7b at full width and depth through the
    Trainer, one warmup step and ``steps`` timed steps."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.trainer import Trainer, TrainerConfig, n_params

    cfg = cfg or ARCHS["qwen3-1.7b"]
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    trainer = Trainer(bundle, TrainerConfig(lr=3e-4, warmup_steps=1, total_steps=1 + steps))
    data = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                            global_batch=B, seed=0, layout=cfg.layout,
                                            sp_degree=bundle.pctx.sp_degree))
    t0 = time.perf_counter()
    state = trainer.init_state(0)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers, {n_params(state['params']) / 1e9:.3f}B "
        f"parameters in {cfg.param_dtype}, compute {cfg.dtype}, remat {cfg.remat}; batch {B} x "
        f"seq {S}; seeded init {time.perf_counter() - t0:.1f} s")
    step_log = lambda m: log("  " + m)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    state, hist = trainer.run(state, data, steps=1, log_every=1, log=step_log)  # warmup
    peak_first = torch.cuda.max_memory_allocated()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    state, timed = trainer.run(state, data, steps=1 + steps, log_every=1, log=step_log)
    peak = torch.cuda.max_memory_allocated()
    got = launch_counts()
    want = {k: v * steps for k, v in train_launches_per_step(cfg).items()}
    if got != want:
        raise AssertionError(f"training path: launches {got} over {steps} steps, expected {want}")
    losses = hist + timed
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training path: losses {losses}")
    step_s = trainer.step_seconds[1:]
    med = statistics.median(step_s)
    res = {"arch": cfg.name, "batch": B, "seq": S, "steps_timed": steps, "step_s": step_s,
           "median_step_s": med, "tokens_per_s": B * S / med,
           "first_step_s": trainer.step_seconds[0], "losses": losses,
           "peak_bytes_timed_steps": peak, "peak_bytes_first_step": peak_first,
           "launches": got}
    log(f"  timed steps {[round(x, 4) for x in step_s]} s: median {med:.4f} s = "
        f"{B * S / med:.1f} tok/s; losses {[round(x, 4) for x in losses]}; peak memory "
        f"{peak / 2**30:.2f} GiB (first step {peak_first / 2**30:.2f} GiB); launches {got}")
    if with_profile:
        res["profile"] = profile_step(torch, lambda: trainer.run(
            state, data, steps=2 + steps, log=lambda m: None), med)
    log("RESULT training " + json.dumps(res))
    return got


# ---------------------------------------------------------------------------
# phases 10 and 11: the ring (TokenRing and the ring baselines) on the
# virtual ring of P ranks folded into the batch dimension of one card
# ---------------------------------------------------------------------------

RING_VARIANTS = [  # (label, strategy, travel dtype of TokenRing's accumulator)
    ("tokenring", "tokenring", "float32"),
    ("tokenring travel bf16", "tokenring", "bfloat16"),
    ("tokenring_faithful", "tokenring_faithful", "float32"),
    ("ring", "ring", "float32"),
    ("ring_bidir", "ring_bidir", "float32"),
]
RING_HEADS = (16, 8, 128)  # qwen3-1.7b attention: Hq, Hkv, D
RING_S_LOC = {"bfloat16": 1024, "float32": 512}  # local rows a rank (bidir halves: 512, 256)


def ring_computes(strategy, P):
    """Flash calls of one pass of the strategy's schedule at ring size P."""
    from repro_torch.core.strategies import get_strategy

    sched = get_strategy(strategy).schedule_spec(P).schedule
    return sum(len(st.computes) for st in sched.all_steps())


def ring_positions(torch, dev, B, S, P):
    from repro_torch.core.zigzag import zigzag_positions

    pos = torch.cat([zigzag_positions(S, P, j, device=dev) for j in range(P)])
    return pos.expand(B, S).contiguous()


def ring_run(torch, strategy, travel, P, impl, overlap, q, k, v, pos, w, wl):
    """One ring forward ``(out, lse)`` on global tensors (the strategy's
    per-rank callable on the ranks folded into the batch dimension) and the
    gradients of ``sum(out*w) + sum(lse*wl)`` (live rows) for q, k and v.
    Returns them with the ring's forward link and position bytes."""
    from repro_torch.core.collectives import VirtualRing, fold_ranks, unfold_ranks
    from repro_torch.core.strategies import get_strategy

    ring = VirtualRing(P, q.device)
    xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    fq, fk, fv, fp = (fold_ranks(x, P) for x in (*xs, pos))
    extra = {"travel_dtype": travel} if strategy == "tokenring" else {}
    out, lse = get_strategy(strategy).fn(fq, fk, fv, fp, fp, ring=ring, causal=True, impl=impl,
                                         overlap=overlap, return_lse=True, **extra)
    out, lse = unfold_ranks(out, P), unfold_ranks(lse, P)
    sent = (dict(ring.link_bytes), dict(ring.position_bytes))
    live = torch.where(torch.isneginf(lse), 0.0, lse)
    grads = torch.autograd.grad((out.float() * w).sum() + (live * wl).sum(), xs)
    return out.detach(), lse.detach(), grads, sent


def ring_inputs(torch, dev, gen, B, S, dtype):
    Hq, Hkv, D = RING_HEADS

    def rnd(shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    return (rnd((B, S, Hq, D)), rnd((B, S, Hkv, D)), rnd((B, S, Hkv, D)),
            rnd((B, S, Hq, D), torch.float32), rnd((B, S, Hq), torch.float32))


class EachCall:
    """Inside a ring run on the kernels, hold every flash call against the
    plain version on the same inputs: kernel A's ``(out, lse)`` at phase
    3's limits, B1/B2's float32 ``(dq, dk, dv)`` at phase 7's (per row and
    per tensor in bf16, 1e-4 in float32; rows that see no key and keys that
    no query sees exactly 0).  These are the calls that pair one rank's
    query block with another rank's keys (Sq != Sk, whole blocks masked).
    Keeps the count and the worst readings."""

    def __init__(self, torch, name):
        self.torch, self.name = torch, name
        self.calls = {"fwd": 0, "bwd": 0}
        self.out_err = self.row = self.l2 = 0.0
        self.dead = 0

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.fwd, self.bwd = ops, ops._flash_fwd, ops._flash_bwd
        ops._flash_fwd, ops._flash_bwd = self._fwd, self._bwd
        return self

    def __exit__(self, *exc):
        self.ops._flash_fwd, self.ops._flash_bwd = self.fwd, self.bwd

    def _fwd(self, cfg, q, k, v, qp, kp):
        import dataclasses

        got = self.fwd(cfg, q, k, v, qp, kp)
        if cfg.resolve_impl(q.device) == "cuda":
            want = self.fwd(dataclasses.replace(cfg, impl="torch"), q, k, v, qp, kp)
            err = compare(f"{self.name} A call {self.calls['fwd']}", got, want,
                          **tolerances(q.dtype), quiet=True)
            self.out_err = max(self.out_err, err)
            self.calls["fwd"] += 1
        return got

    def _bwd(self, cfg, q, k, v, qp, kp, out, lse, dout, dlse):
        import dataclasses

        got = self.bwd(cfg, q, k, v, qp, kp, out, lse, dout, dlse)
        if cfg.resolve_impl(q.device) == "cuda":
            want = self.bwd(dataclasses.replace(cfg, impl="torch"), q, k, v, qp, kp, out, lse,
                            dout, dlse)
            limit = (BWD_BF16_LIMIT if q.dtype == self.torch.bfloat16
                     else dict(atol=1e-4, rtol=1e-4))
            dead = dead_masks(self.torch, lse, qp, kp, cfg.causal, cfg.window)
            _, pairs = compare_grads(self.torch, f"{self.name} B1/B2 call {self.calls['bwd']}",
                                     got, want, dead=dead, quiet=True, **limit)
            self.row = max([self.row] + [r for r, _ in pairs])
            self.l2 = max([self.l2] + [x for _, x in pairs])
            self.dead += int(dead[0].sum())
            self.calls["bwd"] += 1
        return got


def phase_ring(torch, dev, ps=(2, 4, 8), s_loc=RING_S_LOC, profile_shape=TRAIN_SHAPE):
    """Every ported strategy on the virtual ring, kernels against the same
    ring on the plain versions on the card; then the overlap trace.

    Limits.  Every kernel call inside the ring is held to phase 3's and
    phase 7's limits (:class:`EachCall`).  The ring's own forward (out, lse)
    is held to phase 3's limits, those of bf16 where the inputs or the
    travelling accumulator are bf16 (the accumulator is rounded to bf16 at
    every merge).  Its gradients: float32 within 1e-4 absolute plus 1e-4
    relative elementwise; bf16 (inputs or accumulator) within phase 7's
    per-tensor limit, ||err|| <= 5e-3 ||plain||, and not per row: the
    gradients of bf16 inputs are stored in bf16 (the flash Function returns
    them in the input's type, as the reference's VJP does) and summed over
    the P blocks in bf16, so one bf16 rounding of a large block term in a
    row whose sum nearly cancels is large against that row's final RMS.
    The phase logs the same per-row reading for one SP-1 flash call with
    bf16 gradients, which shows it too (PERF.md has the readings).
    """
    from repro_torch.core.strategies import get_strategy, strategy_cost
    from repro_torch.kernels.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(10)
    Hq, Hkv, D = RING_HEADS
    B = 1
    checked, worst = 0, {"calls_row": 0.0, "calls_l2": 0.0, "ring_l2_bf16": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        for P in ps:
            S = s_loc[dname] * P
            pos = ring_positions(torch, dev, B, S, P)
            q, k, v, w, wl = ring_inputs(torch, dev, gen, B, S, dtype)
            for label, strategy, travel in RING_VARIANTS:
                name = f"ring {label} P={P} {dname} (B={B} S={S} S_loc={S // P})"
                n = ring_computes(strategy, P)
                reset_launch_counts()
                got = ring_run(torch, strategy, travel, P, "cuda", True, q, k, v, pos, w, wl)
                torch.cuda.synchronize()
                ran = launch_counts()
                want_launches = {"flash_attention_fwd": n, "flash_attention_bwd_dq": n,
                                 "flash_attention_bwd_dkv": n}
                if ran != want_launches:
                    raise AssertionError(f"{name}: launches {ran}, expected {want_launches} "
                                         f"(the schedule's {n} Computes)")
                with EachCall(torch, name) as each:
                    seq = ring_run(torch, strategy, travel, P, "cuda", False, q, k, v, pos, w,
                                   wl)
                if each.calls != {"fwd": n, "bwd": n}:
                    raise AssertionError(f"{name}: checked calls {each.calls}, expected {n}")
                for what, a, b in zip(("out", "lse", "dq", "dk", "dv"),
                                      (got[0], got[1], *got[2]), (seq[0], seq[1], *seq[2])):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name}: overlap=True and overlap=False differ "
                                             f"in {what}")
                plain = ring_run(torch, strategy, travel, P, "torch", True, q, k, v, pos, w, wl)
                # the ring is as precise as its least precise arithmetic: a
                # float32 ring whose accumulator travels in bf16 takes bf16 limits
                least = torch.bfloat16 if travel == "bfloat16" else dtype
                err = compare(f"{name} forward", got[:2], plain[:2], **tolerances(least),
                              quiet=True)
                grads = [g.float() for g in got[2]], [g.float() for g in plain[2]]
                if least == torch.float32:
                    _, pairs = compare_grads(torch, name, *grads, atol=1e-4, rtol=1e-4,
                                             quiet=True)
                else:
                    _, pairs = compare_grads(torch, name, *grads, l2=BWD_BF16_LIMIT["l2"],
                                             elementwise=False, quiet=True)
                    worst["ring_l2_bf16"] = max([worst["ring_l2_bf16"]] + [x for _, x in pairs])
                worst["calls_row"] = max(worst["calls_row"], each.row)
                worst["calls_l2"] = max(worst["calls_l2"], each.l2)
                (link, pos_bytes) = got[3]
                cost = strategy_cost(get_strategy(strategy), B, S, Hq, Hkv, D, P,
                                     bytes_per_elem=q.element_size(), travel_dtype=travel)
                if strategy == "tokenring_faithful" and dtype != torch.float32:
                    bytes_note = ("bytes not compared: the model prices the partial at "
                                  "float32, it travels in bf16")
                elif link != {"fwd": cost.fwd_bytes, "bwd": cost.bwd_bytes}:
                    raise AssertionError(f"{name}: link bytes {link}, cost model "
                                         f"{cost.fwd_bytes}/{cost.bwd_bytes}")
                else:
                    bytes_note = f"link bytes {link['fwd']:.0f}/{link['bwd']:.0f} = cost model"
                log(f"  ok {name}: launches {n}/{n}/{n} = Computes; {n}+{n} kernel calls vs "
                    f"plain (worst out {each.out_err:.2e}, grads row {each.row:.2e} / l2 "
                    f"{each.l2:.2e}, {each.dead} dead (row, head) exactly 0); ring vs plain ring:"
                    f" out {err:.2e}, grads row/l2 "
                    f"{' '.join(f'{r:.2e}/{x:.2e}' for r, x in pairs)}; overlap True/False "
                    f"bitwise equal; {bytes_note}, position bytes {pos_bytes['fwd']:.0f}/"
                    f"{pos_bytes['bwd']:.0f} apart")
                checked += 1
    log(f"  {checked} ring cases passed; worst kernel call: grads {worst['calls_row']:.2e} of "
        f"the row RMS, {worst['calls_l2']:.2e} relative L2; worst bf16 ring gradient "
        f"{worst['ring_l2_bf16']:.2e} relative L2")
    # the per-row reading of one SP-1 flash call whose gradients come back in
    # bf16 (the input's type), for comparison with the rings' (logged only)
    S = s_loc["bfloat16"] * 2
    qp = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    q, k, v, w, wl = ring_inputs(torch, dev, gen, B, S, torch.bfloat16)
    sp1 = {}
    for impl in ("cuda", "torch"):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        out, lse = flash_attention(*xs, q_pos=qp, k_pos=qp, causal=True, impl=impl)
        sp1[impl] = [g.float() for g in torch.autograd.grad(
            (out.float() * w).sum() + (lse * wl).sum(), xs)]
    _, pairs = compare_grads(torch, "SP-1 flash, bf16 gradients", sp1["cuda"], sp1["torch"],
                             l2=BWD_BF16_LIMIT["l2"], elementwise=False, quiet=True)
    worst["sp1_bf16_grads_row_l2"] = pairs
    log(f"  one SP-1 flash call (B={B} S={S}, bf16, causal), gradients in bf16, kernels vs "
        f"plain: row/l2 {' '.join(f'{r:.2e}/{x:.2e}' for r, x in pairs)}")
    return {**ring_overlap_trace(torch, dev, gen, **profile_shape), "worst": worst,
            "cases": checked}


def interval_union(spans):
    """Sorted, disjoint union of ``(start, end)`` spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(spans, cover):
    """Length of ``spans`` (a disjoint union) lying inside ``cover`` (one too)."""
    total, j = 0.0, 0
    for a, b in spans:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        i = j
        while i < len(cover) and cover[i][0] < b:
            total += min(b, cover[i][1]) - max(a, cover[i][0])
            i += 1
    return total


def stream_shares(trace_path):
    """From a torch.profiler chrome trace: the compute stream (the one that
    runs the port's kernels), the device time of the other streams (the
    ring's copies), the compute stream's kernel time, and the share of the
    copy time that lies under a running compute-stream kernel."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e]
    stream = lambda e: e.get("args", {}).get("stream", e.get("tid"))  # noqa: E731
    mine = [stream(e) for e in gpu if "rt::" in e.get("name", "")]
    compute = max(set(mine), key=mine.count)
    side = [(e["ts"], e["ts"] + e["dur"]) for e in gpu if stream(e) != compute]
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in gpu
            if stream(e) == compute and e.get("cat") == "kernel"]
    side_u, kern_u = interval_union(side), interval_union(kern)
    copy_us = sum(b - a for a, b in side_u)
    span_us = max(e["ts"] + e["dur"] for e in gpu) - min(e["ts"] for e in gpu)
    busy_us = sum(b - a for a, b in interval_union(side + kern))
    return {"compute_stream": compute, "gpu_span_ms": span_us / 1e3,
            "device_busy_share": busy_us / span_us,
            "side_streams": sorted({str(stream(e)) for e in gpu if stream(e) != compute}),
            "copy_ms": copy_us / 1e3, "copy_events": len(side),
            "kernel_ms": sum(b - a for a, b in kern_u) / 1e3,
            "copy_share_under_kernels": covered(side_u, kern_u) / copy_us if copy_us else 0.0}


def ring_overlap_trace(torch, dev, gen, B, S, Hq, Hkv, D, P=4):
    """TokenRing forward and backward at the training shape on the kernels:
    the overlap=True and overlap=False wall times, then one overlap=True run
    under torch.profiler: the side stream's copies against the compute
    stream's kernels.  One card's copy engines are no NVLink ring: this
    shows overlap, not link bandwidth."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    pos = ring_positions(torch, dev, B, S, P)
    q, k, v, w, wl = ring_inputs(torch, dev, gen, B, S, torch.bfloat16)

    def step(overlap):
        return ring_run(torch, "tokenring", "float32", P, "cuda", overlap, q, k, v, pos, w, wl)

    walls = {}
    for overlap in (True, False, True, False):
        step(overlap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(overlap)
        torch.cuda.synchronize()
        walls.setdefault(overlap, []).append((time.perf_counter() - t0) / 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(True)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        res = stream_shares(path)
    finally:
        os.unlink(path)
    res.update(shape=f"B={B} S={S} P={P} Hq={Hq} Hkv={Hkv} D={D} bf16 causal zigzag, tokenring",
               wall_s_overlap=walls[True], wall_s_sequential=walls[False])
    log(f"  trace ({res['shape']}, forward and backward, overlap=True): {res['copy_events']} "
        f"copies on stream(s) {res['side_streams']} for {res['copy_ms']:.3f} ms, compute stream "
        f"{res['compute_stream']} kernels {res['kernel_ms']:.3f} ms; "
        f"{100 * res['copy_share_under_kernels']:.1f}% of the copy time under a running kernel; "
        f"the device busy {100 * res['device_busy_share']:.1f}% of the "
        f"{res['gpu_span_ms']:.3f} ms from its first to its last kernel")
    log(f"  wall per forward and backward: overlap=True {[round(x, 5) for x in walls[True]]} s, "
        f"overlap=False {[round(x, 5) for x in walls[False]]} s")
    if res["copy_events"] == 0:
        raise AssertionError("ring trace: no copy ran on a side stream")
    return res


def phase_train_ring(torch, dev, with_profile=False, cfg=None, B=2, S=4096, steps=3, P=4,
                     strategy="tokenring"):
    """The ring training path: qwen3-1.7b at full width and depth through the
    Trainer with TokenRing over P virtual ranks on the card, one warmup step
    and ``steps`` timed steps whose launch counts must equal the schedule's
    Computes per layer (A twice under remat "full"); with ``with_profile``,
    one more step under torch.profiler."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = cfg or ARCHS["qwen3-1.7b"]
    pctx = ParallelContext(device="cuda", sp_degree=P, strategy=strategy)
    bundle = build_model(cfg, pctx)
    trainer = Trainer(bundle, TrainerConfig(lr=3e-4, warmup_steps=1, total_steps=1 + steps))
    data = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                            global_batch=B, seed=0, layout=cfg.layout,
                                            sp_degree=P))
    state = trainer.init_state(0)
    step_log = lambda m: log("  " + m)  # noqa: E731
    state, hist = trainer.run(state, data, steps=1, log_every=1, log=step_log)  # warmup
    ring = pctx.ring
    reset_launch_counts()
    ring.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    state, timed = trainer.run(state, data, steps=1 + steps, log_every=1, log=step_log)
    peak = torch.cuda.max_memory_allocated()
    got = launch_counts()
    computes = ring_computes(strategy, P)
    want = {k: v * steps for k, v in train_launches_per_step(cfg, computes).items()}
    if got != want:
        raise AssertionError(f"ring training path: launches {got} over {steps} steps, "
                             f"expected {want}")
    losses = hist + timed
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"ring training path: losses {losses}")
    step_s = trainer.step_seconds[1:]
    med = statistics.median(step_s)
    per_step = {k: v // steps for k, v in got.items()}
    sent = {"link_bytes_per_step": {k: v / steps for k, v in ring.link_bytes.items()},
            "position_bytes_per_step": {k: v / steps for k, v in ring.position_bytes.items()}}
    # the same steps with every send after its step's computes, from the
    # state reached (same launches; recorded beside the overlapped steps)
    seq = Trainer(build_model(cfg, dataclasses.replace(pctx, overlap=False)),
                  TrainerConfig(lr=3e-4, warmup_steps=1, total_steps=2 + 2 * steps))
    seq.run(state, data, steps=2 + 2 * steps, log=lambda m: None)
    seq_s = seq.step_seconds[1:]
    res = {"arch": cfg.name, "strategy": strategy, "sp_degree": P, "ring": "virtual, one card",
           "batch": B, "seq": S, "steps_timed": steps, "step_s": step_s, "median_step_s": med,
           "tokens_per_s": B * S / med, "first_step_s": trainer.step_seconds[0],
           "losses": losses, "peak_bytes_timed_steps": peak, "launches": got,
           "launches_per_step": per_step, **sent, "step_s_overlap_false": seq_s}
    log(f"  {strategy} over {P} virtual ranks: timed steps {[round(x, 4) for x in step_s]} s: "
        f"median {med:.4f} s = {B * S / med:.1f} tok/s; losses {[round(x, 4) for x in losses]}; "
        f"peak memory {peak / 2**30:.2f} GiB; launches per step {per_step}; link bytes per step "
        f"and rank {res['link_bytes_per_step']}, position bytes {res['position_bytes_per_step']}")
    log(f"  the same steps with overlap=False: {[round(x, 4) for x in seq_s]} s")
    if with_profile:
        res["profile"] = profile_step(torch, lambda: trainer.run(
            state, data, steps=2 + steps, log=lambda m: None), med)
    log("RESULT training_ring " + json.dumps(res))
    return got


def free_device_memory(torch):
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs only on the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"no src/repro_torch beside {__file__}: run from a checkout", file=sys.stderr)
        return 2
    profile = "--profile" in sys.argv[1:]
    sys.path.insert(0, str(SRC))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("== phase 1: toolchain")
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True, timeout=60)
    if nvcc.returncode != 0:
        from repro_torch.kernels._build import _nvcc

        nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                              timeout=60, check=True)
    card = smi_line()
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, triton {triton_v}")
    log("  nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    log(f"  card: {card}; device count {torch.cuda.device_count()}")

    log("== phase 2: build")
    from repro_torch.kernels._build import build_all

    info = build_all()
    log(f"  built {info['built']} in {info['seconds']:.2f} s")
    for name, text in info["ptxas"].items():
        for line in text.splitlines():
            if any(x in line for x in ("registers", "spill", "Compiling entry", "C75")):
                log(f"  ptxas {name}: {line.strip()}")
    from repro_torch.kernels import flash_attention as fa

    log("  kernel A wgmma instance: 384 threads (producer warpgroup at 40 registers, two "
        "consumer warpgroups at 232 by setmaxnreg); dynamic shared memory "
        f"{fa.flash_fwd_smem_bytes(128, 4096)} B at D=128, "
        f"{fa.flash_fwd_smem_bytes(64, 4096)} B at D=64 (Sk=4096)")
    log("  kernels B1/B2 wgmma instances: 384 threads (producer warpgroup at 24 registers, two "
        "consumer warpgroups at 240 by setmaxnreg)")
    log("  decode core (A's decode instance, kernel C; csrc/decode.cuh): 128 threads a block, "
        "32-key tiles through a 3-stage cp.async ring, splits aiming at "
        f"{fa.DECODE_BLOCKS_PER_SM} blocks per SM "
        f"({torch.cuda.get_device_properties(dev).multi_processor_count} SMs)")

    log("== phase 3: kernel A (flash forward) vs plain")
    flash_rows = phase_flash(torch, dev)
    log("== phase 4: kernel C (paged decode) vs plain")
    paged_row = phase_paged(torch, dev)
    log("== phase 5: paged and dense-slab engines on the kernels, teacher-forced vs the plain "
        "path")
    phase_e2e_checked(torch, dev)
    log("== phase 6: qwen3-1.7b full width and depth, serving")
    launches, sp1_outputs = phase_full(torch, dev, profile)
    free_device_memory(torch)
    log("== phase 7: kernels B1 and B2 (flash backward) vs plain")
    bwd_rows = phase_bwd(torch, dev)
    free_device_memory(torch)
    log("== phase 8: one training step on the kernels vs the plain path")
    phase_train_checked(torch, dev)
    free_device_memory(torch)
    phase_train_checked_bf16(torch, dev)
    free_device_memory(torch)
    log("== phase 9: qwen3-1.7b full width and depth, training")
    launches["train"] = phase_train_full(torch, dev, profile)
    free_device_memory(torch)
    log("== phase 10: the ring strategies on the kernels vs the plain path, virtual ring of P "
        "ranks on one card")
    ring_trace = phase_ring(torch, dev)
    free_device_memory(torch)
    phase_train_checked(torch, dev, S=1024, label="phase 10 ring step (tokenring, P=4)",
                        sp_degree=4, strategy="tokenring")
    free_device_memory(torch)
    log("== phase 11: qwen3-1.7b full width and depth, training through TokenRing over 4 "
        "virtual ranks (main path)")
    launches["train_ring"] = phase_train_ring(torch, dev, profile)
    free_device_memory(torch)
    log("== phase 12: sequence-parallel serving on the kernels vs the plain path, virtual ring "
        "of P ranks on one card")
    phase_sp_attention(torch, dev)
    free_device_memory(torch)
    sp_rows = phase_sp_main_shapes(torch, dev)
    free_device_memory(torch)
    phase_e2e_checked(torch, dev, sp_degree=4, label="phase 12")
    free_device_memory(torch)
    log("== phase 13: qwen3-1.7b full width and depth, served over 4 virtual ranks (main path)")
    sp_launches, sp_outputs = phase_full(torch, dev, profile, sp_degree=4,
                                         reference=sp1_outputs)
    launches.update(sp_launches)
    free_device_memory(torch)
    teacher_forced_witness(torch, dev, sp_outputs)

    log("== phase 14: summary")
    # `launches` is the count of the main path that runs the kernel (A and
    # C: paged serving over 4 virtual ranks, phase 13; B1 and B2: training
    # through TokenRing, phase 11); `launches_by_path` gives every driven
    # path's count, each read from counters set to 0 just before that run.
    # A's and C's times, errors and bounds are those of phase 13's calls
    # (phase 12): A's resident call of a paged prefill chunk, its other
    # calls under `sp4_calls`.
    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in launches.items()}

    bwd = "src/repro/kernels/flash_attention.py:476"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:244",
         "launches": launches["paged_sp4"]["flash_attention_fwd"],
         "launches_by_path": by_path("flash_attention_fwd"),
         "device_kernels": {"wgmma": ["rt::wg::flash_fwd_wgmma_kernel<D>"],
                            "decode": ["rt::dec::decode_kernel<T, D, WR, RW, false>"],
                            "cuda_core": ["rt::flash_fwd_kernel<T, D>"]},
         **sp_rows["paged_prefill_resident"],
         "sp4_calls": {k: v for k, v in sp_rows.items()
                       if k not in ("paged_prefill_resident", "paged_decode")},
         "training_shape": bwd_rows["fwd"],
         "serving_prefill_shape": flash_rows[256], "decode_shape": flash_rows[1],
         "ring_overlap_trace": ring_trace},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_bwd.cu",
         "replaces": bwd, "pallas_body": "src/repro/kernels/flash_attention.py:367",
         "launches": launches["train_ring"]["flash_attention_bwd_dq"],
         "launches_by_path": by_path("flash_attention_bwd_dq"), **bwd_rows["dq"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_bwd.cu",
         "replaces": bwd, "pallas_body": "src/repro/kernels/flash_attention.py:415",
         "launches": launches["train_ring"]["flash_attention_bwd_dkv"],
         "launches_by_path": by_path("flash_attention_bwd_dkv"), **bwd_rows["dkv"]},
        {"name": "paged_decode_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:192",
         "launches": launches["paged_sp4"]["paged_decode_fwd"],
         "launches_by_path": by_path("paged_decode_fwd"),
         "device_kernels": ["rt::dec::decode_kernel<T, D, WR, RW, true>"],
         **sp_rows["paged_decode"], "sp1_serving_shape": paged_row},
    ]
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

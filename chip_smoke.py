#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. toolchain: torch, CUDA, nvcc and the card's name and power limit;
  2. build every kernel in ``src/repro_torch/csrc`` with nvcc (sm_90a);
  3. kernel A (flash forward) against its plain version on the card, in
     float32 and bf16, the zigzag, window, dead-row and ragged edge cases
     included; each call's log names the instance that served it (the
     wgmma instance: bf16, D 64/128, Sq > 4; else the CUDA-core one);
  4. kernel C (fused paged decode) against its plain version on the card;
  5. the paged engine at qwen3-1.7b widths (2 layers, float32) on the
     kernels, every emitted token teacher-forced against the plain path;
  6. the serving path: qwen3-1.7b at full width and depth (28 layers, bf16,
     seeded random weights) served by the paged engine and the dense-slab
     engine, each with its own kernel launch counts, held against its
     prefill ticks and decode steps; with ``--profile``, the paged run once
     more under torch.profiler (device busy share and the kernels that take
     the most device time; adds minutes);
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
 10. a ``{"kernels": [...]}`` summary line, the card line, and last the
     ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Timings are CUDA-event medians after warmup.
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


def compare(name, got, want, atol, rtol, lse_tol):
    """Raise unless kernel ``(out, lse)`` matches the plain version; dead
    rows (plain lse = -inf) must be exactly (0, -inf).  Returns max |err|."""
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
        instance of kernel A that served the call."""
        inst = fa.flash_fwd_instance(q.dtype, q.shape[1], q.shape[-1])
        name = f"A {short(q.dtype)} {label} [{inst}]"
        return compare(name, *run(q, k, v, qp, kp, causal, window), **tolerances(q.dtype))

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
        ms = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True,
                                                         window=None, scale=scale))
        plain_ms = time_ms(lambda: fa.flash_attention_fwd_torch(
            q, k, v, qp, kp, causal=True, window=None, scale=scale, block_k=512), iters=3)
        mask = (kp[:, None, None, :] < PAD_POS // 2) & (qp[:, None, :, None] >= kp[:, None, None, :])
        # yardstick only: SDPA gives out without lse; KV repeated for GQA
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(Hq // Hkv, dim=2).transpose(1, 2) for x in (k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        nbytes, flops = flash_bytes_flops(q, k, qp, kp, True, None)
        bms, by = bound(nbytes, flops, "bfloat16")
        inst = fa.flash_fwd_instance(q.dtype, Sq, D)
        rows[Sq] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                        max_abs_err=err, instance=inst,
                        shape=f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} bf16")
        log(f"  A serving Sq={Sq} [{inst}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
    return rows


# ---------------------------------------------------------------------------
# phase 4: kernel C
# ---------------------------------------------------------------------------

PAGED_CASES = [
    ("ps1_mha", 1, (2, 2), (1, 3), None),
    ("ps4_gqa", 4, (8, 2), (3, 4, 5), None),
    ("ps8_mqa", 8, (4, 1), (8, 23), None),
    ("ps16_boundary", 16, (4, 4), (15, 16, 17, 64), None),
    ("ps8_window", 8, (4, 2), (40, 7), 16),
    # rows longer than one split of the kernel, so the merge pass combines
    # several partials (the plain version never splits)
    ("ps4_splits", 4, (8, 2), (300, 77, 129), None),
    ("ps8_window_splits", 8, (4, 2), (500, 33), 40),
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
    from repro_torch.kernels import paged_attention as pa

    def to_dev(data, dtype):
        return [torch.from_numpy(x).to(dev).to(dtype if x.dtype.kind == "f" else torch.int32)
                .contiguous() for x in data]

    def run(data, lengths, window):
        q, kp, vp, pos, bt, qp = data
        scale = 1.0 / q.shape[-1] ** 0.5
        got = pa.paged_decode_fwd_cuda(q, kp, vp, pos, bt, qp, window=window, scale=scale)
        want = pa.paged_decode_fwd_torch(q, kp, vp, pos, bt, qp, lengths=lengths, window=window,
                                         scale=scale, block_k=512)
        return got, want

    for dtype in (torch.float32, torch.bfloat16):
        for case_id, ps, heads, lengths, window in PAGED_CASES:
            data = to_dev(paged_case_data(case_id, ps, heads, lengths), dtype)
            lens = torch.tensor(lengths, device=dev, dtype=torch.int32)
            splits = -(-data[4].shape[1] // pa.entries_per_split(ps))
            compare(f"C {str(dtype)[6:]} {case_id} ({splits} splits)", *run(data, lens, window),
                    **tolerances(dtype))
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
    splits = -(-raw[4].shape[1] // pa.entries_per_split(16))
    compare(f"C f32 serving ps=16 ({splits} splits)", *run(to_dev(raw, torch.float32), lens, None),
            **tolerances(torch.float32))
    data = to_dev(raw, torch.bfloat16)
    err = compare(f"C bf16 serving ps=16 ({splits} splits)", *run(data, lens, None),
                  **tolerances(torch.bfloat16))
    q, kp, vp, pos, bt, qp = data
    scale = 1.0 / 128 ** 0.5
    ms = time_ms(lambda: pa.paged_decode_fwd_cuda(q, kp, vp, pos, bt, qp, window=None,
                                                  scale=scale), iters=20)
    plain_ms = time_ms(lambda: pa.paged_decode_fwd_torch(q, kp, vp, pos, bt, qp, lengths=lens,
                                                         window=None, scale=scale, block_k=512),
                       iters=5)
    pages_used = int((bt < kp.shape[0]).sum())
    ps, Hkv, D = 16, 8, 128
    nbytes = (pages_used * ps * Hkv * D * 2 * 2 + pages_used * ps * 4 + bt.numel() * 4
              + 2 * q.numel() * 2 + q.shape[0] * q.shape[2] * 4)
    flops = 4.0 * D * 16 * sum(lengths)
    bms, by = bound(nbytes, flops, "bfloat16")
    log(f"  C serving: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}), "
        f"{nbytes / ms / 1e6:.1f} GB/s over {pages_used} pages")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                max_abs_err=err, shape=f"B=8 ps=16 Hq=16 Hkv=8 D=128 pages={pages_used} bf16")


# ---------------------------------------------------------------------------
# phases 5 and 6: the engine
# ---------------------------------------------------------------------------


def make_prompts(n, lo, hi, vocab, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(L)).astype(np.int32) for L in lengths]


def phase_e2e_checked(torch, dev):
    """qwen3-1.7b widths, 2 layers, float32: paged engine on the kernels,
    each emitted token teacher-forced against the plain path on the card."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda
    from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = ARCHS["qwen3-1.7b"].with_(n_layers=2, dtype="float32")
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    params = bundle.init(0)
    max_len = 512
    eng = ServingEngine(bundle, params, max_batch=4, max_len=max_len, prefill_chunk=128,
                        token_budget=256, page_size=16, device=dev)
    a0, c0 = flash_attention_fwd_cuda.launches, paged_decode_fwd_cuda.launches
    reqs = [eng.submit(p, max_new_tokens=16) for p in make_prompts(6, 40, 300, cfg.vocab_size)]
    eng.run()
    if flash_attention_fwd_cuda.launches == a0 or paged_decode_fwd_cuda.launches == c0:
        raise AssertionError("phase 5 did not run through both kernels")
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda"))
    worst = 0.0
    for r in reqs:
        if len(r.output) != 16:
            raise AssertionError(f"request {r.uid} emitted {len(r.output)} tokens")
        state = plain.init_serve_state(1, max_len, dev)
        head = torch.from_numpy(r.prompt[:-1][None].copy()).to(dev)
        plain.prefill_chunk(params, head, state,
                            torch.tensor([head.shape[1]], device=dev, dtype=torch.int32))
        feed = [int(r.prompt[-1])] + r.output[:-1]
        for t, (tok_in, tok_out) in enumerate(zip(feed, r.output)):
            logits, state = plain.decode_step(params, torch.tensor([tok_in], device=dev), state)
            row = logits[0].float()
            gap = float(row.max() - row[tok_out])
            worst = max(worst, gap)
            if gap > 1e-3:
                raise AssertionError(f"req {r.uid} step {t}: token {tok_out} is {gap:.2e} "
                                     "below the plain path's max logit")
    log(f"  ok phase 5: {len(reqs)} requests x 16 tokens within 1e-3 of the plain path "
        f"(worst gap {worst:.2e})")


def serve_run(torch, dev, bundle, params, *, n_requests, paged, seed=0):
    from repro_torch.serving.engine import ServingEngine

    kw = dict(page_size=16) if paged else {}
    eng = ServingEngine(bundle, params, max_batch=8 if paged else 4, max_len=2048,
                        prefill_chunk=256, token_budget=512, device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32)
            for p in make_prompts(n_requests, 128, 1024, bundle.cfg.vocab_size, seed)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if r.status != "done" or len(r.output) != 32:
            raise AssertionError(f"request {r.uid}: {r.status}, {len(r.output)} tokens")
        if not all(0 <= t < bundle.cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: token out of vocabulary")
    s = eng.stats()
    s["wall_s"] = wall
    s["tok_s"] = s["tokens"] / wall
    s["prompt_tokens"] = int(sum(len(r.prompt) for r in reqs))
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


def profile_run(torch, dev, bundle, params, unprofiled_wall_s):
    """The paged run once more under torch.profiler: device busy time (sum of kernel
    times on the one stream) against the profiled wall, and the kernels that
    take the most device time.  The profiler adds host time per op, so its
    wall is above the unprofiled run's; the busy time over the unprofiled
    run's wall (same requests, same kernels) is printed beside it as the
    estimate of the unprofiled run's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = serve_run(torch, dev, bundle, params, n_requests=16, paged=True)
    rows = device_rows(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    log(f"  profiled paged run: wall {s['wall_s']:.3f} s, device busy {busy_s:.3f} s "
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


def phase_full(torch, dev, with_profile):
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels.paged_attention import paged_decode_fwd_cuda
    from repro_torch.models.registry import build_model

    cfg = ARCHS["qwen3-1.7b"]
    bundle = build_model(cfg, ParallelContext(device="cuda"))
    t0 = time.perf_counter()
    params = bundle.init(0)
    torch.cuda.synchronize()
    log(f"  weights: {cfg.n_layers} layers, {cfg.dtype}, seeded init {time.perf_counter() - t0:.1f} s")
    serve_run(torch, dev, bundle, params, n_requests=2, paged=True, seed=99)  # warmup
    torch.cuda.reset_peak_memory_stats()
    runs, launches = {}, {}
    for path, n_requests, paged in (("paged", 16, True), ("dense", 4, False)):
        reset_launch_counts()
        s = serve_run(torch, dev, bundle, params, n_requests=n_requests, paged=paged)
        got = {**launch_counts(), "paged_decode_fwd": paged_decode_fwd_cuda.launches}
        # every prefill tick runs A twice per layer (resident + chunk-local
        # partial); a decode step runs C (paged) or A (dense) once per layer;
        # serving runs no backward
        L, ticks, steps = cfg.n_layers, s["prefill_steps"], s["decode_steps"]
        want = ({"flash_attention_fwd": 2 * L * ticks, "paged_decode_fwd": L * steps} if paged
                else {"flash_attention_fwd": 2 * L * ticks + L * steps, "paged_decode_fwd": 0})
        want.update(flash_attention_bwd_dq=0, flash_attention_bwd_dkv=0)
        if got != want:
            raise AssertionError(f"{path} path: launches {got}, expected {want} from "
                                 f"{ticks} prefill ticks and {steps} decode steps")
        runs[path], launches[path] = s, got
    if min(launches["paged"]["flash_attention_fwd"], launches["paged"]["paged_decode_fwd"]) == 0:
        raise AssertionError(f"a kernel was not launched on the paged path: {launches}")
    peak = torch.cuda.max_memory_allocated()
    for name, s in runs.items():
        log(f"  run {name}: {s['requests']} requests, {s['tokens']} tokens "
            f"({s['prompt_tokens']} prompt) in {s['wall_s']:.3f} s = {s['tok_s']:.2f} tok/s, "
            f"mean TTFT {s['mean_ttft_s'] * 1e3:.1f} ms, mean latency "
            f"{s['mean_latency_s'] * 1e3:.1f} ms, {s['prefill_steps']} prefill ticks, "
            f"{s['decode_steps']} decode steps, {s['preemptions']} preemptions, "
            f"launches {launches[name]}")
    log(f"  peak memory {peak / 2**30:.2f} GiB")
    prof = (profile_run(torch, dev, bundle, params, runs["paged"]["wall_s"])
            if with_profile else None)
    log("RESULT serving " + json.dumps({**{k: {kk: vv for kk, vv in v.items()
                                                 if not isinstance(vv, dict)}
                                             for k, v in runs.items()},
                                         "peak_bytes": peak, "launches": launches,
                                         "profile_paged": prof}))
    return launches


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


def compare_grads(torch, name, got, want, atol=0.0, rtol=0.0, row=0.0, l2=None, dead=None):
    """Raise unless each of dq/dk/dv is finite and within ``atol + rtol *
    |plain| + row * rms(plain row)`` of the plain version elementwise (a row
    is the D values of one (batch, position, head)), ``||err|| <= l2 *
    ||plain||`` when ``l2`` is given, and, given ``dead = (rows, keys)``, the
    dq rows that see no key and the dk/dv rows of keys that no query sees
    are exactly 0.  Returns the largest |error|."""
    worst, readings = 0.0, []
    for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {g_name}: not finite")
        err = (g - w).abs()
        rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
        rel_row = float((err / rms).nan_to_num(0.0, posinf=float("inf")).max())
        rel_l2 = float(err.norm() / w.norm())
        if not torch.all(err <= atol + rtol * w.abs() + row * rms):
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
    log(f"  ok {name}: max|grad err| {worst:.3e} (max |err|/rms(row) / ||err||/||plain||: "
        f"{', '.join(readings)}){n_dead}, a second run bitwise equal")
    return worst


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
    err = compare_grads(torch, f"B1/B2 bf16 training shape {shape} [{inst}]", got, want,
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


def train_launches_per_step(cfg):
    """remat "full" runs A in the forward and again in each block's
    recompute; B1 and B2 once per layer."""
    L = cfg.n_layers
    return {"flash_attention_fwd": (2 if cfg.remat == "full" else 1) * L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L}


def kernels_vs_plain_step(torch, dev, cfg, B, S):
    """One loss-and-gradient step of ``cfg`` on the kernels and one on the
    plain path, from the same parameters and batch.  Returns both losses,
    gradients and parameters, and the kernel launches of the first."""
    from repro_torch.core.api import ParallelContext
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset
    from repro_torch.launch.train_step import value_and_grad
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime.trainer import batch_to_device

    kern = build_model(cfg, ParallelContext(device="cuda"))
    plain = build_model(cfg, ParallelContext(impl="torch", device="cuda"))
    p_kern = kern.init(0, training=True)
    p_plain = tree_map(lambda t: t.detach().clone(), p_kern)
    batch = batch_to_device(next(SyntheticDataset(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=1))), dev)
    before = launch_counts()
    (l_kern, _), g_kern = value_and_grad(kern.loss, p_kern, batch)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    if ran != train_launches_per_step(cfg):
        raise AssertionError(f"phase 8: kernel launches {ran}, expected "
                             f"{train_launches_per_step(cfg)}")
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


def phase_train_checked(torch, dev, cfg=None, B=2, S=512):
    """One step at qwen3-1.7b widths, 2 layers, float32: kernels vs plain."""
    from repro_torch.configs import ARCHS
    from repro_torch.optim.adamw import adamw_init, adamw_update

    cfg = cfg or ARCHS["qwen3-1.7b"].with_(n_layers=2, dtype="float32")
    l_kern, l_plain, g_kern, g_plain, p_kern, p_plain, ran = kernels_vs_plain_step(
        torch, dev, cfg, B, S)
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
    log(f"  ok phase 8: loss {float(l_kern):.6f} vs plain {float(l_plain):.6f} (|err| "
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

    log("== phase 3: kernel A (flash forward) vs plain")
    flash_rows = phase_flash(torch, dev)
    log("== phase 4: kernel C (paged decode) vs plain")
    paged_row = phase_paged(torch, dev)
    log("== phase 5: paged engine on the kernels, teacher-forced vs the plain path")
    phase_e2e_checked(torch, dev)
    log("== phase 6: qwen3-1.7b full width and depth, serving")
    launches = phase_full(torch, dev, profile)
    free_device_memory(torch)
    log("== phase 7: kernels B1 and B2 (flash backward) vs plain")
    bwd_rows = phase_bwd(torch, dev)
    free_device_memory(torch)
    log("== phase 8: one training step on the kernels vs the plain path")
    phase_train_checked(torch, dev)
    free_device_memory(torch)
    phase_train_checked_bf16(torch, dev)
    free_device_memory(torch)
    log("== phase 9: qwen3-1.7b full width and depth, training (main path)")
    launches["train"] = phase_train_full(torch, dev, profile)

    # `launches` is the count of each kernel's own slice path (training for
    # A, B1 and B2; paged serving for C); `launches_by_path` gives every
    # driven path's count, each read from counters set to 0 just before that
    # run.
    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in launches.items()}

    bwd = "src/repro/kernels/flash_attention.py:476"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:244",
         "launches": launches["train"]["flash_attention_fwd"],
         "launches_by_path": by_path("flash_attention_fwd"), **bwd_rows["fwd"],
         "serving_prefill_shape": flash_rows[256], "decode_shape": flash_rows[1]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_bwd.cu",
         "replaces": bwd, "pallas_body": "src/repro/kernels/flash_attention.py:367",
         "launches": launches["train"]["flash_attention_bwd_dq"],
         "launches_by_path": by_path("flash_attention_bwd_dq"), **bwd_rows["dq"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_bwd.cu",
         "replaces": bwd, "pallas_body": "src/repro/kernels/flash_attention.py:415",
         "launches": launches["train"]["flash_attention_bwd_dkv"],
         "launches_by_path": by_path("flash_attention_bwd_dkv"), **bwd_rows["dkv"]},
        {"name": "paged_decode_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/paged_attention.py:192",
         "launches": launches["paged"]["paged_decode_fwd"],
         "launches_by_path": by_path("paged_decode_fwd"),
         "device_kernels": ["paged_decode_split_kernel", "paged_decode_merge_kernel"],
         **paged_row},
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

#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each fatal on failure:
  1. toolchain: torch, CUDA, nvcc and the card's name and power limit;
  2. build every kernel in ``src/repro_torch/csrc`` with nvcc (sm_90a);
  3. kernel A (flash forward) against its plain version on the card;
  4. kernel C (fused paged decode) against its plain version on the card;
  5. the paged engine at qwen3-1.7b widths (2 layers, float32) on the
     kernels, every emitted token teacher-forced against the plain path;
  6. the main path: qwen3-1.7b at full width and depth (28 layers, bf16,
     seeded random weights) served by the paged engine (the main path) and
     the dense-slab engine, each with its own kernel launch counts, held
     against its prefill ticks and decode steps; with ``--profile``, the
     paged run once more under torch.profiler (device busy share and the
     kernels that take the most device time; adds minutes);
  7. a ``{"kernels": [...]}`` summary line, the card line, and last the
     ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Timings are CUDA-event medians after warmup.
"""

from __future__ import annotations

import json
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
                compare(f"A {str(dtype)[6:]} {(B, Sq, Sk, Hq, Hkv, D)} causal={causal}",
                        *run(q, k, v, qp, kp, causal, None), **tolerances(dtype))
    # zigzag positions (P = 4), sliding window, dead rows
    S, P = 256, 4
    half = S // (2 * P)
    zz = []
    for j in range(P):
        zz += list(range(j * half, (j + 1) * half))
        zz += list(range((2 * P - 1 - j) * half, (2 * P - j) * half))
    q, k, v = (rnd((2, S, 2, 64), torch.float32) for _ in range(3))
    zp = torch.tensor(zz, device=dev, dtype=torch.int32).expand(2, S).contiguous()
    compare("A f32 zigzag", *run(q, k, v, zp, zp, True, None), **tolerances(torch.float32))
    ar = torch.arange(S, device=dev, dtype=torch.int32).expand(2, S).contiguous()
    compare("A f32 window=48", *run(q, k, v, ar, ar, True, 48), **tolerances(torch.float32))
    kp = ar.clone()
    kp[1] = PAD_POS
    qp = ar.clone()
    qp[0, :16] = -1
    compare("A f32 dead rows", *run(q, k, v, qp, kp, True, None), **tolerances(torch.float32))
    # ragged edge: lengths that are no multiple of the kernel's tiles
    q, k, v = rnd((2, 37, 4, 32), torch.float32), rnd((2, 45, 2, 32), torch.float32), rnd(
        (2, 45, 2, 32), torch.float32)
    qp = (torch.arange(37, device=dev, dtype=torch.int32) + 8).expand(2, 37).contiguous()
    kp = torch.arange(45, device=dev, dtype=torch.int32).expand(2, 45).contiguous()
    compare("A f32 ragged 37x45", *run(q, k, v, qp, kp, True, None), **tolerances(torch.float32))

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
        compare(f"A {dict(float32='f32', bfloat16='bf16')[str(dtype)[6:]]} chunk-local Sq=Sk=256",
                *run(qc.to(dtype), kc.to(dtype), vc.to(dtype), cp, cp, True, None),
                **tolerances(dtype))
    rows = {}
    for Sq in (1, 256):
        q32 = rnd((B, Sq, Hq, D), torch.float32)
        q = q32.to(torch.bfloat16)
        qp = (rng_lengths[:, None] - (1 if Sq == 1 else 0)
              + torch.arange(Sq, device=dev)[None]).to(torch.int32).contiguous()
        compare(f"A f32 serving Sq={Sq} Sk={Sk}", *run(q32, k32, v32, qp, kp, True, None),
                **tolerances(torch.float32))
        err = compare(f"A bf16 serving Sq={Sq} Sk={Sk}", *run(q, k, v, qp, kp, True, None),
                      **tolerances(torch.bfloat16))
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
        rows[Sq] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                        max_abs_err=err, shape=f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} bf16")
        log(f"  A serving Sq={Sq}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
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
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
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
            "top": [{"ms": us / 1e3, "count": c, "kernel": k[:120]} for us, c, k in rows[:10]]}


def phase_full(torch, dev, with_profile):
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda
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
        flash_attention_fwd_cuda.launches = 0
        paged_decode_fwd_cuda.launches = 0
        s = serve_run(torch, dev, bundle, params, n_requests=n_requests, paged=paged)
        got = {"flash_attention_fwd": flash_attention_fwd_cuda.launches,
               "paged_decode_fwd": paged_decode_fwd_cuda.launches}
        # every prefill tick runs A twice per layer (resident + chunk-local
        # partial); a decode step runs C (paged) or A (dense) once per layer
        L, ticks, steps = cfg.n_layers, s["prefill_steps"], s["decode_steps"]
        want = ({"flash_attention_fwd": 2 * L * ticks, "paged_decode_fwd": L * steps} if paged
                else {"flash_attention_fwd": 2 * L * ticks + L * steps, "paged_decode_fwd": 0})
        if got != want:
            raise AssertionError(f"{path} path: launches {got}, expected {want} from "
                                 f"{ticks} prefill ticks and {steps} decode steps")
        runs[path], launches[path] = s, got
    if min(launches["paged"].values()) == 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
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
            spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
            if "registers" in line or spills:
                log(f"  ptxas {name}: {line.strip()}")

    log("== phase 3: kernel A (flash forward) vs plain")
    flash_rows = phase_flash(torch, dev)
    log("== phase 4: kernel C (paged decode) vs plain")
    paged_row = phase_paged(torch, dev)
    log("== phase 5: paged engine on the kernels, teacher-forced vs the plain path")
    phase_e2e_checked(torch, dev)
    log("== phase 6: qwen3-1.7b full width and depth (main path)")
    launches = phase_full(torch, dev, "--profile" in sys.argv[1:])

    # `launches` is the main path's count (the paged serving run);
    # `launches_by_path` gives each driven path's own count, each read from
    # counters set to 0 just before that run.
    def by_path(name):
        return {path: counts[name] for path, counts in launches.items()}

    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:244",
         "launches": launches["paged"]["flash_attention_fwd"],
         "launches_by_path": by_path("flash_attention_fwd"), **flash_rows[256],
         "decode_shape": flash_rows[1]},
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

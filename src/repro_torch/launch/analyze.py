"""Static analysis gate of the port: ``python -m repro_torch.launch.analyze --all --fail-on-findings``.

Counterpart of ``repro.launch.analyze``.  Runs every ``repro_torch.analysis``
pass over the registered strategies and a representative shape grid, without
launching a kernel:

  * schedule check  — rank-symbolic walk of each strategy's ``schedule_spec``
    (deadlock, matched sends, merge discipline, carry shapes, coverage);
  * comm audit      — exact per-direction wire bytes vs the registered
    ``comm_cost`` closed form, across P / head-layout / dtype points;
  * kernel lint     — the Hopper instances at the main paths' calls and the
    reference gate's own points: shared memory against the block's opt-in
    maximum, ptxas's spills and serialised ``wgmma``s, the cluster
    instance's one wave, grid and split covers, tile divisibility, tile-skip
    soundness and the paged decode's address rule and sentinel;
  * topology check  — per-link traffic prover (``analysis.topo_check``):
    every schedule replayed onto sample fabrics (flat NVLink pods, a
    two-pod PCIe-bridged grid, a half-duplex pod), demanding the per-link
    ledger matches the registered cost model under the graph's bandwidths.

The reference's jaxpr overlap pre-check has no counterpart (no jaxpr).

``--device cuda`` (the default) reads the card: its opt-in shared memory a
block, its SM count, the clusters of the cluster instance it holds at once,
and ptxas's report of the built library (built on first use).  Without a
card it exits non-zero.  ``--device cpu`` lints against the documented H100
figures (``analysis.kernel_lint.H100``) and skips the ptxas rules, and says
so.  Exit status 0 when clean; with ``--fail-on-findings``, 1 when any pass
reports a finding.  Rule catalog: ``repro_torch.analysis.report.RULES``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch.analysis import kernel_lint as kl
from repro_torch.analysis.comm_audit import audit_strategy
from repro_torch.analysis.report import Report
from repro_torch.analysis.schedule_check import check_schedule_spec

# The grid is small enough to finish in seconds but hits every structural
# regime: MHA vs GQA heads, fp32 vs bf16 wire formats, P covering the P=2
# direction-tie, odd rings, and the loop-body path (P >= 4).
GRID_P = (2, 3, 4, 8)
GRID_HEADS = ((4, 4), (8, 2))  # (Hq, Hkv): MHA and 4:1 GQA
GRID_WIRE = ((4, "float32"), (2, "bfloat16"))  # (bytes_per_elem, travel_dtype)
B, D, S_LOC, WINDOW = 2, 64, 64, 96
PASSES = ("schedule", "comm", "kernel", "topo")

_BF16, _F32 = torch.bfloat16, torch.float32
# The main paths' calls of kernels A, B1 and B2 (PERF.md's table of TPU
# kernels): (subject, dtype, D, B, Sq, Sk, Hq, Hkv, with the backward).
FLASH_CALLS = (
    ("whisper-base cross", _BF16, 64, 16, 4096, 1536, 8, 8, True),
    ("whisper-base encoder", _BF16, 64, 16, 1536, 1536, 8, 8, True),
    ("whisper-base decoder", _BF16, 64, 16, 4096, 4096, 8, 8, True),
    ("whisper-base decode cross", _BF16, 64, 8, 1, 1536, 8, 8, False),
    ("whisper-base decode self", _BF16, 64, 8, 1, 448, 8, 8, False),
    ("qwen3-moe-30b-a3b prefill", _BF16, 128, 8, 256, 2048, 32, 4, False),
    ("qwen3-moe-30b-a3b training", _BF16, 128, 2, 4096, 4096, 32, 4, True),
    ("qwen3-1.7b training", _BF16, 128, 2, 4096, 4096, 16, 8, True),
    ("qwen3-1.7b decode", _BF16, 128, 8, 1, 2048, 16, 8, False),
    ("qwen3-1.7b SP-4 resident", _BF16, 128, 32, 256, 2048, 16, 8, False),
    ("qwen3-1.7b SP-4 chunk-local", _BF16, 128, 8, 256, 256, 16, 8, False),
    ("qwen3-1.7b SP-4 dense resident", _BF16, 128, 16, 256, 512, 16, 8, False),
    ("qwen3-1.7b SP-4 dense decode", _BF16, 128, 16, 1, 512, 16, 8, False),
    ("qwen3-1.7b f32 step", _F32, 128, 2, 512, 512, 16, 8, True),
    ("pixtral-12b prefill", _BF16, 128, 1, 1280, 1280, 32, 8, False),
    ("recurrentgemma-2b training", _BF16, 256, 2, 4096, 4096, 10, 1, True),
    ("recurrentgemma-2b decode", _BF16, 256, 8, 1, 2048, 10, 1, False),
    ("recurrentgemma-2b f32 check", _F32, 256, 2, 4096, 4096, 10, 1, True),
)
# Kernel C's: (subject, dtype, D, B, Hq, Hkv, page size, table width, pool pages).
PAGED_CALLS = (
    ("qwen3-moe-30b-a3b paged decode", _BF16, 128, 8, 32, 4, 16, 128, 1024),
    ("qwen3-1.7b paged decode", _BF16, 128, 8, 16, 8, 16, 128, 1024),
    ("recurrentgemma-2b paged decode", _BF16, 256, 8, 10, 1, 16, 128, 1024),
)
# The port's tiles (q rows x keys) the tile-skip predicate is checked at:
# A's wgmma instance up to D 128 and at D 256 (and A's and B1's CUDA-core
# instances up to D 128), B1's at D 128, A's CUDA-core instance at D 256
# and B2's (64 q rows x 32 keys), B1's and B2's CUDA-core instances at D
# 256 and the decode core's 32-key tiles.
SKIP_TILES = ((128, 128), (64, 64), (128, 64), (64, 32), (32, 32))


def _strategies(names=None):
    # Importing repro_torch.core registers the built-in strategies.
    import repro_torch.core  # noqa: F401
    from repro_torch.core.strategies import available_strategies, get_strategy

    pool = names or available_strategies()
    return [get_strategy(n) for n in pool]


def analyze_schedules(report: Report, descs) -> None:
    for desc in descs:
        if desc.schedule_spec is None:
            continue
        for P in GRID_P:
            spec = desc.schedule_spec(P, S_loc=S_LOC, window=WINDOW)
            report.extend(
                check_schedule_spec(spec, P, subject=f"{desc.name}[P={P}]")
            )
            report.note_checked("schedule")


def analyze_comm(report: Report, descs) -> None:
    for desc in descs:
        if desc.schedule_spec is None:
            continue
        for P in GRID_P:
            for Hq, Hkv in GRID_HEADS:
                for bpe, travel in GRID_WIRE:
                    findings = audit_strategy(
                        desc, B=B, S=S_LOC * P, Hq=Hq, Hkv=Hkv, D=D, P=P,
                        bytes_per_elem=bpe, travel_dtype=travel, window=WINDOW,
                    )
                    report.extend(findings or [])
                    report.note_checked("comm")


def kernel_context(device: str):
    """``(limits, ptxas logs or None)`` for the kernel pass: the card's own
    limits and the built library's ptxas report with ``"cuda"``, the
    documented H100 figures and no ptxas report with ``"cpu"``."""
    if torch.device(device).type == "cpu":
        return kl.H100, None
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu to lint "
                           "against the documented H100 figures")
    from repro_torch.kernels._build import ptxas_logs

    dev = torch.device(device)
    return kl.card_limits(dev.index or 0), ptxas_logs()


def admitted_lengths(limits: kl.CardLimits = kl.H100) -> dict:
    """The longest length (``kernel_lint.INSTANCES``) each wgmma instance
    admits on the card, by instance and head dim."""
    budget = min(limits.smem_optin, kl.KMAX_SMEM)
    return {f"{inst}[D={d}]": kl.max_length(inst, d, budget)
            for inst in ("fwd_wgmma", "bwd_dq_wgmma", "bwd_dkv_wgmma") for d in (64, 128, 256)}


def analyze_kernels(report: Report, limits: kl.CardLimits = kl.H100, logs=None) -> None:
    import numpy as np

    from repro_torch.core.zigzag import contig_positions, zigzag_positions

    report.extend(kl.card_smem_findings(limits, subject=limits.name))
    if logs is not None:
        report.extend(kl.ptxas_findings(logs))
        report.note_checked("ptxas", sum(kl.gated(n) for text in logs.values()
                                         for n in kl.ptxas_functions(text)))
    # The main paths' calls, each with its instances' memory, grids and
    # (decode core) covers and one-wave rule.
    for subject, dtype, d, b, sq, sk, hq, hkv, bwd in FLASH_CALLS:
        report.extend(kl.lint_flash_call(dtype=dtype, D=d, B=b, Sq=sq, Sk=sk, Hq=hq, Hkv=hkv,
                                         backward=bwd, limits=limits, subject=subject))
        report.note_checked("kernel")
    for subject, dtype, d, b, hq, hkv, ps, w, n_pages in PAGED_CALLS:
        report.extend(kl.lint_paged_decode_config(
            dtype=dtype, group=hq // hkv, page_size=ps, n_pages=n_pages, table_width=w, D=d,
            B=b, Hkv=hkv, subject=subject, limits=limits))
        report.note_checked("kernel")
    # The reference gate's own points: A, B1 and B2 at 1024 x 1024, D 64
    # and 128, float32 and bf16 (and at phase 7's ragged 165 x 173, which
    # every instance masks); kernel C over the GQA group x page size grid,
    # with the sentinel and corrupt-table probes.
    for dtype in (_F32, _BF16):
        for d in (64, 128):
            for sq, sk in ((1024, 1024), (165, 173)):
                report.extend(kl.lint_flash_call(
                    dtype=dtype, D=d, B=B, Sq=sq, Sk=sk, Hq=8, Hkv=8, backward=True,
                    limits=limits, subject=f"flash(Sq={sq}, Sk={sk}, D={d}, {str(dtype)[6:]})"))
                report.note_checked("kernel")
                tiles = kl.instance_tiles(dtype, d, sq)
                if kl.ragged(sq, tiles[0]) or kl.ragged(sk, tiles[1]):
                    report.note_checked("kernel_ragged_tail")
            for group in (1, 4, 8):
                for ps in (16, 128):
                    report.extend(kl.lint_paged_decode_config(
                        dtype=dtype, group=group, page_size=ps, n_pages=64, table_width=8,
                        D=d, window=WINDOW, limits=limits,
                        subject=f"PagedDecode(group={group}, page={ps}, D={d}, "
                                f"{str(dtype)[6:]})"))
                    report.note_checked("kernel")
    # Tile-skip soundness over the layouts the strategies produce.
    S = 256
    for P in (2, 4):
        for layout, posf in (("zigzag", zigzag_positions), ("contig", contig_positions)):
            pos = np.stack([np.asarray(posf(S, P, j)) for j in range(P)])
            for window in (None, WINDOW) if layout == "contig" else (None,):
                for bq, bk in SKIP_TILES:
                    subject = (f"tile_skip[{layout}, P={P}, S={S}, block={bq}x{bk}, "
                               f"window={window}]")
                    for j in range(P):
                        report.extend(kl.tile_skip_findings(
                            pos[j:j + 1], pos[j:j + 1], block_q=bq, block_k=bk, causal=True,
                            window=window, subject=subject))
                    report.note_checked("tile_skip")


def analyze_topology(report: Report, descs) -> None:
    from repro_torch.analysis.topo_check import check_strategy_topology
    from repro_torch.core.topology import half_duplex_pod, nvlink_pod, two_pods

    topos = (nvlink_pod(4), nvlink_pod(8), two_pods(4), half_duplex_pod(8))
    for desc in descs:
        if desc.schedule_spec is None:
            continue
        for topo in topos:
            for Hq, Hkv in GRID_HEADS:
                for bpe, travel in GRID_WIRE:
                    findings = check_strategy_topology(
                        desc, topo, B=B, S_loc=S_LOC, Hq=Hq, Hkv=Hkv, D=D,
                        bytes_per_elem=bpe, travel_dtype=travel,
                        window=WINDOW,
                    )
                    if findings is None:
                        continue
                    report.extend(findings)
                    report.note_checked("topo")


def run_analysis(names=None, passes=PASSES, *, device: str = "cuda", limits=None, logs=None):
    """All passes over the registered strategies; returns the ``Report``.
    The kernel pass reads the card (``device="cuda"``) or the documented
    H100 figures (``"cpu"``), unless ``limits`` (and ``logs``) are given."""
    unknown = set(passes) - set(PASSES)
    if unknown:
        raise ValueError(f"unknown passes {sorted(unknown)}; expected some of {PASSES}")
    report = Report()
    descs = _strategies(names)
    if "schedule" in passes:
        analyze_schedules(report, descs)
    if "comm" in passes:
        analyze_comm(report, descs)
    if "kernel" in passes:
        if limits is None:
            limits, logs = kernel_context(device)
        analyze_kernels(report, limits, logs)
    if "topo" in passes:
        analyze_topology(report, descs)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.analyze", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--all", action="store_true",
                    help="analyze every registered strategy (default)")
    ap.add_argument("--strategy", action="append", default=None,
                    help="restrict to one strategy (repeatable)")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help="comma-separated subset of passes to run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; reads the card, fails without one) or cpu "
                         "(documented H100 figures, no ptxas rules)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--verbose", action="store_true",
                    help="list per-pass check counts")
    ap.add_argument("--fail-on-findings", action="store_true",
                    help="exit 1 when any pass reports a finding")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA device; pass --device cpu to lint "
                         "against the documented H100 figures")
    passes = tuple(args.passes.split(","))
    limits = logs = None
    if "kernel" in passes:
        limits, logs = kernel_context(args.device)
    report = run_analysis(names=args.strategy, passes=passes, device=args.device,
                          limits=limits, logs=logs)
    if args.json:
        print(json.dumps({
            "findings": [
                {"rule": f.rule, "subject": f.subject, "detail": f.detail}
                for f in report.findings
            ],
            "checked": dict(report.checked),
            **({"limits": limits.to_json(), "ptxas": logs is not None,
                "admitted": admitted_lengths(limits)} if limits else {}),
        }, indent=2))
    else:
        if limits is not None:
            print(f"kernel limits: {json.dumps(limits.to_json())}")
            print("ptxas rules: " + ("the built library's report" if logs is not None else
                                     "skipped (--device cpu: nothing is built)"))
            if args.verbose:
                print(f"admitted lengths: {json.dumps(admitted_lengths(limits))}")
        print(report.render(verbose=args.verbose))
    if args.fail_on_findings and not report.ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

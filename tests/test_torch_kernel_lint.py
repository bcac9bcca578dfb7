"""The Hopper kernel lint (``repro_torch.analysis.kernel_lint``): the closed
forms of each instance's shared memory, the admitted lengths, the one-wave
rule of the decode core's cluster instance, the grid and split covers, the
tile-skip and paged predicates (held to the JAX package's on the same
positions), and the ptxas rules that ``chip_smoke.py``'s build phase
imports back.  The closed forms are held to the built library's own figures
on the card, by ``chip_smoke.py``'s phase 2."""

import numpy as np
import pytest
import torch

from repro.analysis import kernel_lint as jlint
from repro.core.zigzag import contig_positions as j_contig
from repro.core.zigzag import zigzag_positions as j_zigzag
from repro.kernels.flash_attention import tile_skip as j_tile_skip
from repro_torch.analysis import kernel_lint as kl
from repro_torch.kernels.flash_attention import (
    DECODE_D256_MAX_CLUSTER,
    decode_rule_d256,
    decode_split_rule,
    tile_skip,
)
from repro_torch.kernels.paged_attention import page_read, page_skip
from repro_torch.launch.analyze import FLASH_CALLS, PAGED_CALLS, admitted_lengths

GROWING = ("fwd_wgmma", "bwd_dq_wgmma", "bwd_dkv_wgmma")


def rules(findings):
    return {f.rule for f in findings}


@pytest.mark.parametrize("instance", GROWING)
@pytest.mark.parametrize("D", [64, 128, 256])
def test_smem_estimate_monotone_and_admitted_length(instance, D):
    sizes = [kl.smem_estimate(instance, D, S) for S in (1, 64, 4096, 65536, 10**6)]
    assert sizes == sorted(sizes) and sizes[0] < sizes[-1]
    longest = kl.max_length(instance, D)
    assert kl.smem_findings(instance, D, longest, subject="at") == []
    tile = 64 if instance != "fwd_wgmma" else (64 if D == 256 else 128)
    past = kl.smem_findings(instance, D, longest + tile, subject="past")
    assert rules(past) == {"KERN-SMEM"} and str(longest) in past[0].detail
    assert kl.smem_findings(instance, D, longest + 1, subject="ragged past") != []


def test_admitted_lengths_of_the_layouts():
    """The limits the layouts' own comments state: A at D 256 flags Sk up to
    1,080,576, B1 at D 256 Sk up to ~2.2 M, B2 at D 256 Sq up to 126,976."""
    got = admitted_lengths()
    assert got["fwd_wgmma[D=256]"] == 1080576
    assert got["bwd_dq_wgmma[D=256]"] == 2225152
    assert got["bwd_dkv_wgmma[D=256]"] == 126976
    assert all(n >= 126976 for n in got.values())


def test_fixed_instances_fit_at_every_head_dim():
    for D in (32, 64, 128, 256):
        for inst in ("fwd_cuda_core", "bwd_dq_cuda_core", "bwd_dkv_cuda_core"):
            for dtype in (torch.float32, torch.bfloat16):
                assert kl.smem_findings(inst, D, subject=inst, dtype=dtype) == []
    # the layouts' comments: A 191,504 B at D 128 and 213,776 at D 256, B1
    # 226,064 B at D 128 and 207,888 at D 256, B2 214,416 B at D 256; bf16
    # staging at D 32 halves the rings; the cluster instance's 140,880 B
    # (what decode_cluster_smem reads on the card)
    f32 = torch.float32
    assert kl.smem_estimate("fwd_cuda_core", 128, dtype=f32) == 191504
    assert kl.smem_estimate("fwd_cuda_core", 256, dtype=f32) == 213776
    assert kl.smem_estimate("bwd_dq_cuda_core", 128, dtype=f32) == 226064
    assert kl.smem_estimate("bwd_dq_cuda_core", 256, dtype=f32) == 207888
    assert kl.smem_estimate("bwd_dkv_cuda_core", 256, dtype=f32) == 214416
    for inst in ("fwd_cuda_core", "bwd_dq_cuda_core", "bwd_dkv_cuda_core"):
        assert (kl.smem_estimate(inst, 32, dtype=torch.bfloat16)
                < kl.smem_estimate(inst, 32, dtype=f32))
        # only D 32 has a bf16 instance: wider calls are staged in float32
        assert (kl.smem_estimate(inst, 64, dtype=torch.bfloat16)
                == kl.smem_estimate(inst, 64, dtype=f32))
    assert kl.smem_estimate("decode_cluster", 256) == 140880


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True])
def test_split_decode_smem_monotone_and_within_budget(dtype, paged):
    for D in (32, 64, 128) + ((256,) if dtype == torch.float32 else ()):
        for rows in (1, 2, 3, 4, 8, 10, 16, 32, 64):
            if D == 256 and rows > 16:
                with pytest.raises(ValueError, match="takes no"):
                    kl.smem_estimate("decode_split", D, 32, dtype=dtype, rows=rows, paged=paged)
                continue
            sizes = [kl.smem_estimate("decode_split", D, 32 * t, dtype=dtype, rows=rows,
                                      paged=paged) for t in (1, 2, 16, 64)]
            assert sizes == sorted(sizes) and sizes[0] < sizes[-1]
            assert kl.smem_findings("decode_split", D, 32 * 64, dtype=dtype, rows=rows,
                                    paged=paged, subject="max split") == []


@pytest.mark.parametrize("call", FLASH_CALLS, ids=[c[0] for c in FLASH_CALLS])
def test_every_main_path_call_is_within_budget(call):
    subject, dtype, D, B, Sq, Sk, Hq, Hkv, bwd = call
    assert kl.lint_flash_call(dtype=dtype, D=D, B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv,
                              backward=bwd, subject=subject) == []


@pytest.mark.parametrize("call", PAGED_CALLS, ids=[c[0] for c in PAGED_CALLS])
def test_every_paged_main_path_call_is_within_budget(call):
    subject, dtype, D, B, Hq, Hkv, ps, W, n_pages = call
    assert kl.lint_paged_decode_config(dtype=dtype, group=Hq // Hkv, page_size=ps,
                                       n_pages=n_pages, table_width=W, D=D, B=B, Hkv=Hkv,
                                       subject=subject) == []


def test_card_with_less_shared_memory_fires():
    small = kl.CardLimits(name="small", smem_optin=101376, sm_count=132,
                          clusters=kl.H100.clusters)
    assert rules(kl.card_smem_findings(small, subject="card")) == {"KERN-SMEM"}
    assert kl.card_smem_findings(kl.H100, subject="card") == []
    got = kl.lint_flash_call(dtype=torch.bfloat16, D=128, B=2, Sq=4096, Sk=4096, Hq=16, Hkv=8,
                             backward=True, limits=small, subject="small card")
    assert rules(got) == {"KERN-SMEM"}


def test_cluster_rule_fires_past_one_wave():
    # recurrentgemma's decode: B 8, one KV head: 8 clusters of 8 fit the 15
    # an H100 holds; 16 units take clusters of 8 too and pass them.
    assert decode_rule_d256(2048, 8, 132)[1] == 8 == decode_rule_d256(2048, 16, 132)[1]
    assert kl.cluster_findings(8, 2048, subject="B8") == []
    bad = kl.cluster_findings(16, 2048, subject="B16")
    assert rules(bad) == {"KERN-CLUSTER"} and "2 waves" in bad[0].detail
    # short rows take small clusters, which the card holds more of
    assert kl.cluster_findings(16, 64, subject="short") == []
    got = kl.lint_flash_call(dtype=torch.bfloat16, D=256, B=16, Sq=1, Sk=2048, Hq=10, Hkv=1,
                             subject="B16 decode")
    assert rules(got) == {"KERN-CLUSTER"}


def test_decode_covers_and_a_corrupted_rule():
    for n_keys in (0, 1, 31, 32, 33, 2048, 4097, 10**6):
        for units in (1, 8, 16, 64, 256):
            for inst in ("decode_split", "decode_cluster"):
                assert kl.decode_cover_findings(n_keys, units, instance=inst, sm_count=132,
                                                subject="c") == []

    def short(n_keys, units, sms):  # one split too few
        per, splits = decode_split_rule(n_keys, units, sms)
        return per, max(1, splits - 1)

    bad = kl.decode_cover_findings(4096, 8, instance="decode_split", sm_count=132,
                                   subject="c", rule=short)
    assert rules(bad) == {"KERN-GRID-COVER"}

    def wide(n_keys, units, sms):  # a cluster past the cap
        return 1, 2 * DECODE_D256_MAX_CLUSTER

    bad = kl.decode_cover_findings(16 * 32, 1, instance="decode_cluster", sm_count=132,
                                   subject="c", rule=wide)
    assert rules(bad) == {"KERN-GRID-COVER"} and "passes" in bad[0].detail


def test_grid_cover_and_tile_divisibility():
    assert kl.grid_findings(1024, 1024, block_q=128, block_k=128, subject="g") == []
    # the CUDA instances mask a ragged last tile
    assert kl.grid_findings(96, 1000, block_q=64, block_k=128, subject="g") == []
    assert kl.ragged(1000, 128) and not kl.ragged(1024, 128)
    bad = kl.grid_findings(96, 1024, block_q=0, block_k=64, subject="g")
    assert [f.rule for f in bad] == ["KERN-GRID-COVER"]
    assert kl.lint_flash_call(dtype=torch.bfloat16, D=64, B=1, Sq=256, Sk=256, Hq=1, Hkv=1,
                              backward=True, subject="c") == []
    # s = 2 * odd admits no >= 8-row power-of-two tile: PRE-TILE-DIV, which
    # ops.flash_attention raises for every implementation
    bad = kl.lint_flash_call(dtype=torch.bfloat16, D=64, B=1, Sq=1038, Sk=1024, Hq=1, Hkv=1,
                             subject="c")
    assert rules(bad) == {"PRE-TILE-DIV"}


def _layout(posf, S, p):
    return np.stack([np.asarray(posf(S, p, j)) for j in range(p)])


@pytest.mark.parametrize("layout", ["zigzag", "contig", "contig-window"])
def test_tile_skip_sound_and_the_jax_predicate(layout):
    S, p = 256, 4
    window = 96 if layout == "contig-window" else None
    pos = _layout(j_zigzag if layout == "zigzag" else j_contig, S, p)
    for bq, bk in ((128, 128), (64, 64), (32, 32), (48, 40)):
        for j in range(p):
            qp = pos[j:j + 1]
            assert kl.tile_skip_findings(qp, qp, block_q=bq, block_k=bk, causal=True,
                                         window=window, subject=layout) == []
            assert jlint.tile_skip_findings(qp, qp, block_q=bq, block_k=bk, causal=True,
                                            window=window, subject=layout) == []
    # the port's predicate decides each tile as the reference's does
    q = torch.as_tensor(pos[1])
    for q0 in range(0, S // p, 16):
        for k0 in range(0, S // p, 16):
            qt, kt = q[q0:q0 + 16], q[k0:k0 + 16]
            assert tile_skip(qt, kt, causal=True, window=window) == bool(
                j_tile_skip(qt.numpy(), kt.numpy(), causal=True, window=window))


def test_corrupted_tile_skip_is_caught():
    pos = _layout(j_zigzag, 256, 4)[:1]

    def eager_skip(q_pos, k_pos, *, causal, window):
        return True  # drops live attention mass

    bad = kl.tile_skip_findings(pos, pos, block_q=32, block_k=32, causal=True, window=None,
                                subject="zz", skip_fn=eager_skip)
    assert bad and rules(bad) == {"KERN-LIVE-SKIP"}

    def off_by_one(q_pos, k_pos, *, causal, window):  # causal test one key too eager
        return int(q_pos.max()) <= int(k_pos.min())

    # 31-key tiles (a ragged last one) put a key tile's first key on a q-tile's last row
    pos = _layout(j_contig, 256, 4)[:1]
    assert kl.tile_skip_findings(pos, pos, block_q=32, block_k=31, causal=True, window=None,
                                 subject="c") == []
    assert rules(kl.tile_skip_findings(pos, pos, block_q=32, block_k=31, causal=True,
                                       window=None, subject="c", skip_fn=off_by_one)) == \
        {"KERN-LIVE-SKIP"}


@pytest.mark.parametrize("window", [None, 96])
def test_paged_predicates_sound_and_corruptions_caught(window):
    for ps in (16, 128):
        assert kl.paged_sentinel_findings(n_pages=64, page_size=ps, window=window,
                                          subject="p") == []

    def by_contents(entry, k_pos, q_pos, *, n_pages, window=None):
        # decides from the aliased page's contents, not the raw entry
        return page_skip(0, k_pos, q_pos, n_pages=n_pages, window=window)

    bad = kl.paged_sentinel_findings(n_pages=64, page_size=16, window=window, subject="p",
                                     skip_fn=by_contents)
    assert rules(bad) == {"KERN-PAGED-SENTINEL"} and len(bad) == 2

    def skips_all(entry, k_pos, q_pos, *, n_pages, window=None):
        return True

    bad = kl.paged_sentinel_findings(n_pages=64, page_size=16, window=window, subject="p",
                                     skip_fn=skips_all)
    assert rules(bad) == {"KERN-PAGED-SENTINEL"} and "dropped" in bad[0].detail


def test_paged_address_rule_and_a_corrupted_one():
    table = torch.tensor([[63, 62, 61, 64, 64, 64, 77, -1]], dtype=torch.int32)
    assert [page_read(e, 64) for e in table[0].tolist()] == [63, 62, 61] + [None] * 5
    assert kl.paged_bounds_findings(table, n_pages=64, subject="t") == []
    bad = kl.paged_bounds_findings(table, n_pages=64, subject="t",
                                   read_fn=lambda entry, n_pages: entry)
    assert rules(bad) == {"KERN-PAGED-BOUNDS"} and "5 offending" in bad[0].detail
    assert kl.lint_paged_decode_config(dtype=torch.bfloat16, group=8, page_size=16,
                                       n_pages=64, table_width=8, D=128, subject="c") == []


# ptxas's report in its -v format (the cases of test_torch_chip_smoke_ptxas.py)
DQ256 = "_ZN2rt3wgb25flash_bwd_dq_wgmma_kernelILi256EEEv14CUtensorMap_stS2_S2_S2_PKfS4_Pfiiif"
DKV256 = "_ZN2rt3wgb26flash_bwd_dkv_wgmma_kernelILi256EEEv14CUtensorMap_stS2_S2_PfS7_iiif"
FWD128 = "_ZN2rt2wg22flash_fwd_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_PKiS3_Pfiiif"
DQCORE256 = ("_ZN2rt4core24flash_bwd_dq_core_kernelIfLi256EEEvPKT_S4_S4_S4_PKfS6_S6_PKiS8_"
             "Pfiiiiiiiif")
FWDCORE256 = "_ZN2rt4core21flash_fwd_core_kernelIfLi256EEEvPKT_S4_S4_PKiS6_PS2_Pfiiiiiiiiif"
DKVCORE32 = ("_ZN2rt4core25flash_bwd_dkv_core_kernelI13__nv_bfloat16Li32EEEvPKT_S5_S5_S5_PKfS7_"
             "S7_PKiS9_PfSA_iiiiiiiiif")
CLUSTER = "_ZN2rt3dcl18decode_d256_kernelILb0EEEv14CUtensorMap_stS2_NS_3dec4ArgsE"
CLUSTER_PAGED = "_ZN2rt3dcl18decode_d256_kernelILb1EEEv14CUtensorMap_stS2_NS_3dec4ArgsE"
SPLIT256 = "_ZN2rt3dec13decode_kernelIfLi256ELi4ELi4ELb1EEEvNS0_4ArgsE"


def entry(name, spill=0, regs=168):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers\n")


def c7512(name):
    return ("ptxas warning : (C7512) Potential Performance Loss: wgmma.mma_async instructions "
            "are serialized due to insufficient register resources for the wgmma pipeline in "
            f"the function '{name}'\n")


PTXAS_CASES = [
    ("clean", {"flash_bwd": entry(DQ256) + entry(DKV256), "flash_fwd": entry(FWD128)}, []),
    ("spill_b2_d256", {"flash_bwd": entry(DQ256) + entry(DKV256, spill=8)},
     [("KERN-SPILL", DKV256)]),
    ("c7512_b1_d256", {"flash_bwd": c7512(DQ256) + entry(DQ256) + entry(DKV256)},
     [("KERN-WGMMA-SERIAL", DQ256)]),
    ("spill_a", {"flash_fwd": entry(FWD128, spill=16)}, [("KERN-SPILL", FWD128)]),
    ("spill_b1_cuda_core", {"flash_bwd": entry(DQCORE256, spill=4, regs=255)},
     [("KERN-SPILL", DQCORE256)]),
    ("spill_a_cuda_core", {"flash_fwd": entry(FWDCORE256, spill=8, regs=255)},
     [("KERN-SPILL", FWDCORE256)]),
    ("spill_b2_cuda_core", {"flash_bwd": entry(DKVCORE32, spill=16)},
     [("KERN-SPILL", DKVCORE32)]),
    ("cluster_clean", {"flash_fwd": entry(CLUSTER), "paged_decode": entry(CLUSTER_PAGED)}, []),
    ("cluster_spill", {"flash_fwd": entry(CLUSTER),
                       "paged_decode": entry(CLUSTER_PAGED, spill=24)},
     [("KERN-SPILL", CLUSTER_PAGED)]),
    ("split_decode_spill_not_gated", {"paged_decode": entry(SPLIT256, spill=4)}, []),
    ("spill_and_c7512", {"flash_fwd": c7512(FWD128) + entry(FWD128, spill=8)},
     [("KERN-SPILL", FWD128), ("KERN-WGMMA-SERIAL", FWD128)]),
]


@pytest.mark.parametrize("logs,faulty", [c[1:] for c in PTXAS_CASES],
                         ids=[c[0] for c in PTXAS_CASES])
def test_ptxas_rules(logs, faulty):
    got = kl.ptxas_findings(logs)
    assert [(f.rule, f.subject.split(": ")[1]) for f in got] == faulty
    faults = kl.ptxas_wgmma_faults(logs)
    assert len(faults) == len(faulty)
    for fault, (_, name) in zip(faults, faulty):
        assert name in fault


def test_chip_smoke_takes_the_ptxas_rules_from_the_lint():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    assert chip_smoke.ptxas_functions is kl.ptxas_functions
    assert chip_smoke.ptxas_wgmma_faults is kl.ptxas_wgmma_faults
    assert chip_smoke.CLUSTER_KERNEL == kl.CLUSTER_KERNEL


def test_ptxas_logs_are_kept_beside_the_libraries(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "_build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "build_all", lambda: {"seconds": 0.0, "built": [], "ptxas": {}})
    stems = [src.stem for src in sorted(_build.CSRC.glob("*.cu"))]
    assert stems == ["flash_bwd", "flash_fwd", "paged_decode"]
    for stem in stems:
        (tmp_path / f"lib{stem}.ptxas").write_text(entry(f"{stem}_wgmma_kernel"))
    logs = _build.ptxas_logs()
    assert sorted(logs) == stems and kl.ptxas_findings(logs) == []
    (tmp_path / "libpaged_decode.ptxas").unlink()
    with pytest.raises(RuntimeError, match="missing"):
        _build.ptxas_logs()

"""``chip_smoke.py``'s phase-2 gate on ptxas's report: a spill or a
serialised ``wgmma`` (C7512) in any wgmma instance of kernels A, B1 or B2,
or a spill in the decode core's cluster instance (bf16 D 256) or in A's,
B1's and B2's CUDA-core instances, fails the build phase; the split decode
kernel is not held to it.  The reports here are written in ptxas's ``-v`` format."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

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


CASES = [
    ("clean", {"flash_bwd": entry(DQ256) + entry(DKV256), "flash_fwd": entry(FWD128)}, []),
    ("spill_b2_d256", {"flash_bwd": entry(DQ256) + entry(DKV256, spill=8)}, [DKV256]),
    ("c7512_b1_d256", {"flash_bwd": c7512(DQ256) + entry(DQ256) + entry(DKV256)}, [DQ256]),
    ("spill_a", {"flash_fwd": entry(FWD128, spill=16)}, [FWD128]),
    ("spill_b1_cuda_core", {"flash_bwd": entry(DQCORE256, spill=4, regs=255)}, [DQCORE256]),
    ("spill_a_cuda_core", {"flash_fwd": entry(FWDCORE256, spill=8, regs=255)}, [FWDCORE256]),
    ("spill_b2_cuda_core", {"flash_bwd": entry(DKVCORE32, spill=16)}, [DKVCORE32]),
    ("cuda_core_clean", {"flash_fwd": entry(FWDCORE256, regs=160),
                         "flash_bwd": entry(DQCORE256, regs=168) + entry(DKVCORE32, regs=128)},
     []),
    ("cluster_clean", {"flash_fwd": entry(CLUSTER), "paged_decode": entry(CLUSTER_PAGED)}, []),
    ("cluster_spill", {"flash_fwd": entry(CLUSTER),
                       "paged_decode": entry(CLUSTER_PAGED, spill=24)}, [CLUSTER_PAGED]),
    ("split_decode_spill_not_gated", {"paged_decode": entry(SPLIT256, spill=4)}, []),
]


@pytest.mark.parametrize("logs,faulty", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_ptxas_wgmma_gate(logs, faulty):
    faults = chip_smoke.ptxas_wgmma_faults(logs)
    assert len(faults) == len(faulty)
    for fault, name in zip(faults, faulty):
        assert name in fault


def test_ptxas_functions_reads_each_entry():
    funcs = chip_smoke.ptxas_functions(entry(DQ256) + c7512(DKV256) + entry(DKV256, spill=8,
                                                                           regs=170))
    assert funcs[DQ256] == dict(registers=168, spill_stores=0, spill_loads=0, c7512=False)
    assert funcs[DKV256] == dict(registers=170, spill_stores=8, spill_loads=8, c7512=True)

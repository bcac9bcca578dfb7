"""Architecture registry of the port: the dense, MoE, VLM,
encoder-decoder, SSM and hybrid configs (copies of ``repro.configs``).
"""

from repro_torch.configs.falcon_mamba_7b import CONFIG as falcon_mamba_7b
from repro_torch.configs.granite_3_8b import CONFIG as granite_3_8b
from repro_torch.configs.llama2_7b import CONFIG as llama2_7b
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from repro_torch.configs.olmo_1b import CONFIG as olmo_1b
from repro_torch.configs.pixtral_12b import CONFIG as pixtral_12b
from repro_torch.configs.qwen2_72b import CONFIG as qwen2_72b
from repro_torch.configs.qwen3_1_7b import CONFIG as qwen3_1_7b
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from repro_torch.configs.recurrentgemma_2b import CONFIG as recurrentgemma_2b
from repro_torch.configs.whisper_base import CONFIG as whisper_base

ARCHS = {c.name: c for c in [qwen3_moe_30b_a3b, llama4_scout_17b_a16e, granite_3_8b, qwen3_1_7b,
                             olmo_1b, qwen2_72b, pixtral_12b, llama2_7b, whisper_base,
                             falcon_mamba_7b, recurrentgemma_2b]}
# the dry run's archs, in the reference's order (its ASSIGNED)
ASSIGNED = ["falcon-mamba-7b", "qwen3-moe-30b-a3b", "llama4-scout-17b-a16e", "whisper-base",
            "recurrentgemma-2b", "granite-3-8b", "qwen3-1.7b", "olmo-1b", "qwen2-72b",
            "pixtral-12b"]


def get_config(name: str):
    return ARCHS[name]

"""Architecture registry of the port: the dense, MoE and VLM configs.

Copies of ``repro.configs``; the recurrent and encoder-decoder families
come with their slices.
"""

from repro_torch.configs.granite_3_8b import CONFIG as granite_3_8b
from repro_torch.configs.llama2_7b import CONFIG as llama2_7b
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from repro_torch.configs.olmo_1b import CONFIG as olmo_1b
from repro_torch.configs.pixtral_12b import CONFIG as pixtral_12b
from repro_torch.configs.qwen2_72b import CONFIG as qwen2_72b
from repro_torch.configs.qwen3_1_7b import CONFIG as qwen3_1_7b
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b

ARCHS = {c.name: c for c in [qwen3_moe_30b_a3b, llama4_scout_17b_a16e, granite_3_8b, qwen3_1_7b,
                             olmo_1b, qwen2_72b, pixtral_12b, llama2_7b]}


def get_config(name: str):
    return ARCHS[name]

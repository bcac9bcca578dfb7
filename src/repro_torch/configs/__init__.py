"""Architecture registry of the port: the dense-family configs.

Copies of ``repro.configs``; the other families come with their slices.
"""

from repro_torch.configs.granite_3_8b import CONFIG as granite_3_8b
from repro_torch.configs.llama2_7b import CONFIG as llama2_7b
from repro_torch.configs.olmo_1b import CONFIG as olmo_1b
from repro_torch.configs.qwen2_72b import CONFIG as qwen2_72b
from repro_torch.configs.qwen3_1_7b import CONFIG as qwen3_1_7b

ARCHS = {c.name: c for c in [granite_3_8b, qwen3_1_7b, olmo_1b, qwen2_72b, llama2_7b]}


def get_config(name: str):
    return ARCHS[name]

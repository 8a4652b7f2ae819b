"""Architecture registry: ``--arch <id>`` resolves here. The port holds
every architecture of the JAX package's zoo, each at its published
widths and as a smoke config: the dense token LMs (Qwen1.5-0.5B,
Granite-3.0-2B, DeepSeek-67B), the MoEs (Phi-3.5-MoE, DeepSeek-V2-Lite
with MLA), MiniCPM3-4B (MLA), RecurrentGemma-9B (RG-LRU with local
attention), xLSTM-1.3B, and the Qwen2-VL-72B and MusicGen-medium
backbones."""
from . import (deepseek_67b, deepseek_v2_lite, granite_3_2b, minicpm3_4b,
               musicgen_medium, phi3_5_moe, qwen1_5_0_5b, qwen2_vl_72b,
               recurrentgemma_9b, xlstm_1_3b)
from .shapes import SHAPES, ShapeSpec, applicable, input_specs  # noqa: F401

_MODULES = [qwen1_5_0_5b, granite_3_2b, deepseek_67b, minicpm3_4b,
            phi3_5_moe, deepseek_v2_lite, xlstm_1_3b, recurrentgemma_9b,
            qwen2_vl_72b, musicgen_medium]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(name: str, smoke: bool = False):
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]

"""Architecture registry: ``--arch <id>`` resolves here. The port holds
the architectures it runs, each at its published widths and as a smoke
config: the dense token LMs (Qwen1.5-0.5B, Granite-3.0-2B, DeepSeek-67B)
and the MoE Phi-3.5-MoE. The other archs of the JAX package's zoo
(:data:`PENDING`) are ROADMAP queue 1 step 3, and asking for one says
so."""
from . import deepseek_67b, granite_3_2b, phi3_5_moe, qwen1_5_0_5b

_MODULES = [qwen1_5_0_5b, granite_3_2b, deepseek_67b, phi3_5_moe]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}

#: the JAX package's archs the port does not run yet
PENDING = ("deepseek-v2-lite-16b", "minicpm3-4b", "musicgen-medium",
           "qwen2-vl-72b", "recurrentgemma-9b", "xlstm-1.3b")


def get_config(name: str, smoke: bool = False):
    if name in PENDING:
        raise KeyError(f"unknown arch {name!r} to the port: the rest of "
                       f"the LM zoo is ROADMAP queue 1 step 3; it has "
                       f"{sorted(ARCHS)}")
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]

"""Architecture registry: ``--arch <id>`` resolves here. The port holds
the architectures it runs: Qwen1.5-0.5B (the rest of the JAX package's
zoo is ROADMAP step 8)."""
from . import qwen1_5_0_5b

_MODULES = [qwen1_5_0_5b]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_config(name: str, smoke: bool = False):
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]

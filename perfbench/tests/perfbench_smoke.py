"""The cells' files cut to a size the CPU runs in seconds: the same
drivers, traffic generator and references, at smoke widths."""
import copy

from perfbench.harness import core

#: MiniCPM3's smoke shape (``repro_torch.configs.minicpm3_4b.SMOKE``)
LM_SMOKE = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, intermediate_size=128, vocab_size=256,
                q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=8,
                qk_rope_head_dim=4, v_head_dim=8, port={"attn_block_k": 32},
                init={"embed_std": 1.0})


def cnn_files(res: int = 16, batch: int = 2) -> dict:
    files = core.cell_files("resnet50.analyze.b256")
    files["config"] = dict(files["config"], resolution=res)
    files["traffic"] = dict(files["traffic"], batch=batch, pool=1,
                            warm_calls=0)
    files["cell"] = dict(files["cell"], trace_skip=0, trace_units=1)
    return files


def serve_files(cell: str) -> dict:
    files = copy.deepcopy(core.cell_files(cell))
    files["config"] = dict(files["config"], **LM_SMOKE)
    t = dict(files["traffic"])
    t["clients"] = min(t["clients"], 4)
    t["prompt"] = dict(t["prompt"], lo=max(4, t["prompt"]["lo"] // 16),
                       hi=max(8, t["prompt"]["hi"] // 16))
    t["output"] = dict(t["output"], lo=max(2, t["output"]["lo"] // 16),
                       hi=max(3, t["output"]["hi"] // 16))
    if "prefixes" in t:
        t["prefixes"] = dict(t["prefixes"], length=64)
    files["traffic"] = t
    e = files["cell"]["engine"]
    if "max_slots" in e:
        e["max_slots"] = 4
    e["cache_len"] = 256 if "paging" in e else 512
    if "paging" in e:
        e["paging"]["max_rows"] = 4
    files["cell"]["check"] = {"requests": 4}
    files["cell"]["trace_skip"] = 0
    files["cell"]["trace_units"] = 2
    return files


def run(cell: str, files: dict, seed: int = 2 ** 31 + 12345,
        seconds: float = 0.5, trace: bool = False, **kw) -> dict:
    return core.run_cell(core.benchmark(), cell, seed, seconds, trace, "cpu",
                         files=files, **kw)

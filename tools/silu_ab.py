"""A/B of the decode step's SiLU on the card: ``F.silu`` (one rounding)
against the port's SiLU rounded step by step as XLA's on the CPU
(``repro_torch.models.layers.silu``, 8 launches, and an earlier form of it
in 14). Qwen1.5-0.5B at full width, 4 rows, plain matmuls (no kernel
build), host clock over 40 warm decode steps, the variants alternated 3
times in each order. Run from the repository root on a GPU machine:

    python tools/silu_ab.py
"""
import subprocess
import sys
import time

sys.path.insert(0, "src")
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def silu14(h):
    dt = h.dtype
    f = h.float()
    e = torch.exp(-f).to(dt).float()
    d = (1.0 + e).to(dt).float()
    return (f * torch.div(f.new_ones(()), d).to(dt).float()).to(dt)


print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip())
cfg = get_config("qwen1.5-0.5b")
gen = torch.Generator(device="cuda").manual_seed(0)
with torch.no_grad():
    w = lm.compute_weights(lm.init_model(cfg, gen), cfg)
    states = lm.make_decode_state(cfg, 4, 256, torch.bfloat16, "cuda")
    step = lm.make_decode_step(cfg, "ref")
    toks = torch.randint(0, cfg.vocab, (4, 1), device="cuda")
    pos = torch.full((4, 1), 10, device="cuda")
    variants = {"F.silu": F.silu, "silu14": silu14, "silu8": L.silu}
    x = torch.randn(4, 2816, device="cuda").to(torch.bfloat16)
    assert torch.equal(silu14(x), L.silu(x))

    def run(fn, n=40):
        L._ACTS["silu"] = fn
        for _ in range(5):
            step(w, states, toks, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(w, states, toks, pos)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    res = {}
    for name in ["F.silu", "silu14", "silu8", "silu8", "silu14",
                 "F.silu"] * 3:
        res.setdefault(name, []).append(run(variants[name]))
    for k, v in res.items():
        print(k, "warm decode step ms (4 rows, plain matmuls):",
              [round(t, 3) for t in v])

"""Beyond-paper: the power monitor applied to LM architectures.

The paper studies CNNs; this benchmark streams real (activation, weight)
operand pairs from transformer architectures through the same 128x128
SA model (the counter kernel, K1, on the card), answering: do the
paper's two exploits survive on LMs?

Expected (and measured) outcome: weight-mantissa BIC still helps (weights
are still near-zero Gaussians); input-zero gating is workload-dependent --
SiLU/GELU residual streams have almost no exact zeros, while MoE capacity
dispatch has entire zero rows (dropped tokens). This is the paper's
"selective, application-aware" lesson carried to LMs.

The weights are drawn from ``torch.Generator`` seeds (0 for the models,
1 for the MoE layer); :func:`run` takes any weights, e.g. the JAX
package's carried across.

Run:  python -m repro_torch.bench.power_monitor_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import SMOKES
from repro_torch.core import monitor, systolic
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod

from .common import row, timed

ARCHS = ("qwen1.5-0.5b", "phi3.5-moe-42b-a6.6b")
MOE_ARCH = "phi3.5-moe-42b-a6.6b"


def moe_config() -> moe_mod.MoEConfig:
    """The MoE arch's layer config at capacity factor 0.8: dropped tokens
    leave whole zero rows in the dispatch buffers."""
    return dataclasses.replace(SMOKES[MOE_ARCH].moe, capacity_factor=0.8)


def run(params: dict, moe_params: dict, device="cuda") -> dict:
    """Monitor each arch's first attention ``wq`` on its embedded tokens
    and an expert's ``w_gate`` on a capacity-dispatch buffer, printing the
    rows. ``params`` maps each of :data:`ARCHS` to its float32 masters
    (:func:`repro_torch.models.lm.init_model`'s tree), ``moe_params`` is
    a :func:`repro_torch.models.moe.make_moe` tree at :func:`moe_config`.
    Returns ``{arch: metrics, "moe_dispatch": metrics}`` (floats, the MoE
    entry with ``zero_rows``)."""
    mcfg = monitor.MonitorConfig(geometry=systolic.MXU_SA)
    rng = np.random.default_rng(0)
    out = {}

    for name in ARCHS:
        cfg = SMOKES[name]
        p = params[name]
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, 64))).to(device)
        x, _ = lm.embed_inputs(p["embed"].to(torch.bfloat16), cfg, tokens)
        wq = p["layers"][len(cfg.head)]["mixer"]["wq"]

        def measure():
            return {k: float(v) for k, v in monitor.monitor_matmul(
                x.reshape(-1, x.shape[-1]), wq, mcfg).items()}

        m, us = timed(measure, iters=1)
        out[name] = m
        row(f"monitor_{name}_zero_frac", us, f"{m['zero_fraction']:.3f}")
        row(f"monitor_{name}_saving", us,
            f"{m['saving_total']*100:.2f}% (BIC-dominated)")

    # MoE dispatch: dropped tokens create all-zero rows -> ZVG territory
    cfg = SMOKES[MOE_ARCH]
    mcfg2 = moe_config()
    xx = torch.from_numpy(
        (rng.standard_normal((2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    ).to(device, torch.bfloat16)
    logits = xx.float() @ moe_params["router"]
    cap = max(int(16 * mcfg2.top_k * mcfg2.capacity_factor
                  / mcfg2.num_experts), 1)
    dispatch, _, _ = moe_mod._topk_dispatch(
        logits.reshape(2, 16, -1), mcfg2.top_k, cap)
    xin = torch.einsum("gsec,gsd->gecd", dispatch.to(xx.dtype),
                       xx.reshape(2, 16, -1))
    flat = xin.reshape(-1, cfg.d_model)
    zero_rows = float((flat.abs().amax(dim=1) == 0).to(torch.float32)
                      .mean())
    m = {k: float(v) for k, v in monitor.monitor_matmul(
        flat, moe_params["w_gate"][0], mcfg).items()}
    out["moe_dispatch"] = {"zero_rows": zero_rows, **m}
    row("monitor_moe_dispatch_zero_rows", 0.0, f"{zero_rows*100:.1f}%")
    row("monitor_moe_dispatch_saving", 0.0,
        f"{m['saving_total']*100:.2f}% (ZVG re-activated by capacity "
        f"dispatch)")
    print(f"#   MoE dispatch buffers: {zero_rows*100:.0f}% all-zero rows "
          f"-> the paper's ZVG applies to LMs through MoE capacity "
          f"routing")
    return out


def main(device="cuda") -> dict:
    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    with torch.no_grad():
        params = {name: lm.init_model(SMOKES[name], gen(0))
                  for name in ARCHS}
        moe_params = moe_mod.make_moe(SMOKES[MOE_ARCH].d_model,
                                      moe_config(), gen(1))
        return run(params, moe_params, device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default)")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    main(device=args.device)

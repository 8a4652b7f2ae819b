"""repro_torch.design -- first-class systolic-array design points.

    from repro_torch import design

    d = design.DesignPoint("mine", west=design.ZVG,
                           north=design.BIC(bic.MANT_EXP))
    ev = design.evaluate_operands(A, W, [design.PAPER_BASELINE,
                                         design.PAPER_PROPOSED, d])
    design.savings(ev)["mine"]["saving_total"]

One stream pass over the operands (``sa_design_report``) prices any
number of designs; ``select`` picks the cheapest design per site.

Layers:
  point    -- Coding / DesignPoint / the paper pair / the named menu.
  evaluate -- menu-args grouping, per-design pricing, batched evaluation.
  select   -- greedy per-site selection, swap deltas, pareto front.
"""
from __future__ import annotations

from .evaluate import (design_energy, evaluate, evaluate_batched,
                       evaluate_operands, menu_args, savings)
from .point import (BIC, NONE, PAPER_BASELINE, PAPER_PAIR, PAPER_PROPOSED,
                    ZVG, ApproxPE, Coding, DesignPoint, named_designs,
                    paper_pair, resolve_designs)
from .select import (SELECTED, Selection, pareto_front, select_sites,
                     swap_deltas)

__all__ = [
    "Coding", "DesignPoint", "ApproxPE", "BIC", "ZVG", "NONE",
    "PAPER_BASELINE", "PAPER_PROPOSED", "PAPER_PAIR",
    "paper_pair", "named_designs", "resolve_designs",
    "design_energy", "evaluate", "evaluate_operands", "evaluate_batched",
    "menu_args", "savings",
    "Selection", "SELECTED", "select_sites", "swap_deltas", "pareto_front",
]

"""The systolic-array energy model the program prices with: stream facts,
the coding menu of each edge, the pricing of a design, and the per-site
greedy selection.

Frozen copy, as of this benchmark's first version, of
``src/repro_torch/core/systolic.py`` (``menu_lane_sums``,
``stream_facts``, ``edge_streams``'s padding and layout),
``src/repro_torch/design/evaluate.py`` (``menu_args``, ``design_energy``),
``src/repro_torch/core/power.py`` (``EnergyModel``'s defaults,
``price_components``), ``src/repro_torch/design/point.py``
(``named_designs``, ``paper_pair``) and ``src/repro_torch/design/
select.py`` (``select_sites``), in the same float32 operation order, so
that the same counts price to the same floats. ``dtype`` prices in
another precision (the control prices in bfloat16).
"""
from __future__ import annotations

import torch

from . import counters as C

ROWS = COLS = 16                     # the paper's 16x16 array
MANT = (0x007F,)
MANT_EXP = (0x007F, 0x7F80)
FULL = (0xFFFF,)

#: EnergyModel defaults (fJ)
E = dict(E_REG_BIT=6.0, E_WIRE_BIT=18.0, E_CLK_BIT=1.8, E_MULT=450.0,
         E_ADD=400.0, MULT_STATIC_FRAC=0.01, MULT_PP_FRAC=0.80,
         ADD_STATIC_FRAC=0.01, ACC_TOGGLE_BITS=12.8, UNLOAD_TOGGLE_BITS=12.8,
         REG_BITS_PER_PE=72.0, GATEABLE_BITS_PER_PE=42.0, E_ZDET=8.0,
         E_ENC=60.0, E_DEC_XOR_BIT=0.8, MANT_FRAC=7.0 / 16.0, MANT_BITS=7.0,
         BUS_BITS=16.0, E_CTRL_CYCLE=160.0, CLK_LEAF_FRAC=0.18)
E["E_STREAM_BIT"] = E["E_REG_BIT"] + E["E_WIRE_BIT"]

COMPONENTS = ("streaming", "clock", "control", "mult", "add", "acc",
              "unload", "overhead")


def design(name, west=(None, False), north=(None, False)) -> dict:
    """A design: per edge ``(bic segments or None, zvg)``."""
    return {"name": name, "west": west, "north": north}


#: ``named_designs()``: the 7-design menu, in its order
NAMED = (design("baseline"),
         design("proposed", (None, True), (MANT, False)),
         design("bic-only", (None, False), (MANT, False)),
         design("zvg-only", (None, True), (None, False)),
         design("bic-west", (MANT, True), (MANT, False)),
         design("mant-exp", (None, True), (MANT_EXP, False)),
         design("full-bus", (None, True), (FULL, False)))

#: the paper pair (the power accountant's default monitor)
PAPER_PAIR = NAMED[:2]


def designs(names) -> tuple:
    by = {d["name"]: d for d in NAMED}
    return tuple(by[n] for n in names)


def menu(designs_: tuple) -> dict:
    """The union of menu entries a design list needs (one stream group)."""
    g = {"west_bic": [], "north_bic": [], "west_zvg": False,
         "north_zvg": False}
    for d in designs_:
        for edge in ("west", "north"):
            bic, zvg = d[edge]
            if bic is not None and bic not in g[f"{edge}_bic"]:
                g[f"{edge}_bic"].append(bic)
            if zvg:
                g[f"{edge}_zvg"] = True
    return {"west_bic": tuple(sorted(g["west_bic"])),
            "north_bic": tuple(sorted(g["north_bic"])),
            "west_zvg": g["west_zvg"], "north_zvg": g["north_zvg"]}


# --------------------------------------------------------------- streams
def pad_to(x: torch.Tensor, mult: int, dim: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def words(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 bus words of ``x`` as int32 0..65535 (round to nearest
    even; no NaN reaches these streams)."""
    if x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def edge_streams(A: torch.Tensor, W: torch.Tensor):
    """West words ``[(B,) K, Mp]`` and North words ``[(B,) K, Np]`` of
    ``A [(B,) M, K] @ W [(B,) K, N]``, M and N padded with zero words."""
    a = pad_to(words(A), ROWS, -2).transpose(-1, -2).contiguous()
    b = pad_to(words(W), COLS, -1).contiguous()
    return a, b


# ------------------------------------------------------------------ menu
def _f(v, dt=torch.float32) -> torch.Tensor:
    return torch.tensor(v, dtype=dt)


def host_sums(lanes: list, dt=torch.float32) -> list:
    sums = torch.stack([v.sum(dim=-1, dtype=torch.int64) for v in lanes])
    return list(sums.cpu().to(dt))


def menu_lane_sums(rows: dict, prefix: str, bic_variants: tuple,
                   with_zvg: bool, dt=torch.float32) -> dict:
    lanes = {f"{prefix}_raw": rows["raw"],
             f"{prefix}_mant_raw": rows["mant_raw"]}
    if with_zvg:
        lanes[f"{prefix}_zvg"] = rows["zvg"]
        lanes[f"{prefix}_mant_zvg"] = rows["mant_zvg"]
        lanes[f"{prefix}_iszero"] = rows["iszero"]
    for segs in bic_variants:
        k = C.seg_key(segs)
        lanes[f"{prefix}_bic/{k}"] = (rows[f"bic/{k}/data"]
                                      + rows[f"bic/{k}/inv"])
        if with_zvg:
            lanes[f"{prefix}_bic_zvg/{k}"] = (rows[f"bic_zvg/{k}/data"]
                                             + rows[f"bic_zvg/{k}/inv"])
    return dict(zip(lanes, host_sums(list(lanes.values()), dt)))


def _fused_sub_mul(a, b, c, dt):
    return (a.double() - b.double() * c.double()).to(dt)


def stream_facts(M: int, K: int, N: int, az_rows, nz_rows,
                 dt=torch.float32) -> dict:
    R, Cc = ROWS, COLS
    Mp, Np = M + (-M) % R, N + (-N) % Cc
    Tm, Tn = Mp // R, Np // Cc
    nz_rows = nz_rows.expand(az_rows.shape)     # one north stream, B rows
    zeros, zeros_n, overlap = host_sums(
        [az_rows, nz_rows, az_rows.to(torch.int64) * nz_rows], dt)
    inv_words = 1.0 / (_f(Mp, dt) * K)
    pe_slots = _f(Mp, dt) * Np * K
    zero_fraction = zeros * inv_words
    active_frac = _fused_sub_mul(_f(1.0, dt), zeros, inv_words, dt)
    nonzero_slots = _fused_sub_mul(pe_slots, _f(Np, dt), zeros, dt)
    fill = R + Cc - 2
    cycles = _f(Tm, dt) * Tn * (K + fill)
    unload = _f(Tm, dt) * Tn * Cc * R * (R + 1) / 2.0
    return {"Mp": _f(Mp, dt), "Np": _f(Np, dt), "Tm": _f(Tm, dt),
            "Tn": _f(Tn, dt), "rows": _f(R, dt), "cols": _f(Cc, dt),
            "cycles": cycles, "pe_slots": pe_slots,
            "nonzero_slots": nonzero_slots, "active_frac": active_frac,
            "w_zeros": zeros, "n_zeros": zeros_n, "gated_overlap": overlap,
            "zero_fraction": zero_fraction,
            "unload_reg_traversals": unload,
            "west_words": _f(Tn, dt) * Mp * K,
            "north_words": _f(Tm, dt) * Np * K}


def report(a_words, b_words, M: int, K: int, N: int, m: dict,
           dts=(torch.float32,), block_words: int = 1 << 26) -> list:
    """The coding menu and facts of one tiled matmul from its two edge
    streams (the reference's ``sa_design_report``): one counter pass per
    edge, the sums rounded to each dtype of ``dts``, one report each."""
    wrows = C.rows(m["west_bic"], m["west_zvg"])
    nrows = C.rows(m["north_bic"], m["north_zvg"])
    wc, wz = C.counters(a_words, m["west_bic"], m["west_zvg"], block_words)
    nc, nz = C.counters(b_words, m["north_bic"], m["north_zvg"], block_words)
    out = []
    for dt in dts:
        rep = menu_lane_sums({n: wc[..., i, :] for i, n in enumerate(wrows)},
                             "w", m["west_bic"], m["west_zvg"], dt)
        rep.update(menu_lane_sums(
            {n: nc[..., i, :] for i, n in enumerate(nrows)}, "n",
            m["north_bic"], m["north_zvg"], dt))
        rep.update(stream_facts(M, K, N, wz, nz, dt))
        out.append(rep)
    return out


# --------------------------------------------------------------- pricing
def _edge_toggles(rep, prefix, coding):
    bic, zvg = coding
    if zvg and bic is not None:
        return rep[f"{prefix}_bic_zvg/{C.seg_key(bic)}"] + rep[f"{prefix}_iszero"]
    if zvg:
        return rep[f"{prefix}_zvg"] + rep[f"{prefix}_iszero"]
    if bic is not None:
        return rep[f"{prefix}_bic/{C.seg_key(bic)}"]
    return rep[f"{prefix}_raw"]


def _mult_toggles(rep, prefix, coding, mant):
    field = "mant_" if mant else ""
    if coding[1]:
        return rep[f"{prefix}_{field}zvg"]
    return rep[f"{prefix}_{field}raw"]


def _mult_energy(slots, tog_a, tog_b, mtog_a, mtog_b):
    static = E["MULT_STATIC_FRAC"] * E["E_MULT"] * slots
    dyn = (1.0 - E["MULT_STATIC_FRAC"]) * E["E_MULT"]
    pp = E["MULT_PP_FRAC"] * dyn * (mtog_a + mtog_b) / E["MANT_BITS"]
    ex = (1.0 - E["MULT_PP_FRAC"]) * dyn * (tog_a + tog_b) / E["BUS_BITS"]
    return static + pp + ex


def price(rep: dict, d: dict) -> dict:
    """``{"energy": {component: fJ, "total"}, "h", "v", "cycles",
    "zero_fraction"}`` of design ``d`` from a menu report."""
    cw, cn = d["west"], d["north"]
    Mp, Np, Tm, Tn = rep["Mp"], rep["Np"], rep["Tm"], rep["Tn"]
    h_tog = Tn * COLS * _edge_toggles(rep, "w", cw)
    v_tog = Tm * ROWS * _edge_toggles(rep, "n", cn)
    a_tog = Np * _mult_toggles(rep, "w", cw, False)
    a_mant = Np * _mult_toggles(rep, "w", cw, True)
    b_tog = rep["active_frac"] * Mp * _mult_toggles(rep, "n", cn, False)
    b_mant = rep["active_frac"] * Mp * _mult_toggles(rep, "n", cn, True)
    gated = 0.0
    if cw[1]:
        gated = Np * rep["w_zeros"]
    if cn[1]:
        gated = gated + Mp * rep["n_zeros"]
        if cw[1]:
            gated = gated - rep["gated_overlap"]
    overhead = 0.0
    if cw[1]:
        overhead = overhead + E["E_ZDET"] * rep["west_words"]
    if cn[1]:
        overhead = overhead + E["E_ZDET"] * rep["north_words"]
    if cw[0] is not None:
        overhead = overhead + E["E_ENC"] * rep["west_words"]
    if cn[0] is not None:
        overhead = overhead + E["E_ENC"] * rep["north_words"]
    if cw[0] is not None:
        overhead = overhead + E["E_DEC_XOR_BIT"] * E["MANT_FRAC"] * a_tog
    if cn[0] is not None:
        overhead = overhead + E["E_DEC_XOR_BIT"] * E["MANT_FRAC"] * b_tog
    cyc = torch.clamp_min(rep["cycles"], 1.0)
    n_pe = rep["rows"] * rep["cols"]
    slots = rep["pe_slots"]
    nonzero = rep["nonzero_slots"]
    c = {}
    c["streaming"] = E["E_STREAM_BIT"] * (h_tog + v_tog)
    clk_full = E["E_CLK_BIT"] * E["REG_BITS_PER_PE"] * n_pe * cyc
    clk_saved = (E["E_CLK_BIT"] * E["GATEABLE_BITS_PER_PE"]
                 * E["CLK_LEAF_FRAC"] * gated)
    c["clock"] = clk_full - clk_saved
    c["control"] = E["E_CTRL_CYCLE"] * n_pe * cyc
    c["mult"] = _mult_energy(slots - gated, a_tog, b_tog, a_mant, b_mant)
    c["add"] = E["E_ADD"] * (E["ADD_STATIC_FRAC"] * (slots - gated)
                             + (1 - E["ADD_STATIC_FRAC"]) * nonzero)
    c["acc"] = E["E_REG_BIT"] * E["ACC_TOGGLE_BITS"] * nonzero
    c["unload"] = (E["E_STREAM_BIT"] * E["UNLOAD_TOGGLE_BITS"]
                   * rep["unload_reg_traversals"])
    c["overhead"] = overhead
    c["total"] = sum(c[k] for k in COMPONENTS)
    return {"energy": c, "h": h_tog, "v": v_tog, "cycles": rep["cycles"],
            "zero_fraction": rep["zero_fraction"]}


def evaluate(rep: dict, designs_: tuple) -> dict:
    return {d["name"]: price(rep, d) for d in designs_}


def select(site_designs: dict, reference: str = "baseline",
           primary: str = "proposed") -> dict:
    """Greedy per-site choice: the design of least total energy at each
    site (``{site: name}``), ties to the earlier design."""
    choices = {}
    for site, ds in site_designs.items():
        choices[site] = min(ds, key=lambda n: float(ds[n]["total"]))
    return choices

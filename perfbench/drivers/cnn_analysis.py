"""The CNN analysis cell: one caller in a closed loop analyses batches of
synthetic images through the port's composed entry -- the forward with
operand capture (``nets.forward_with_traces``), every site priced for
the design menu (``analysis.analyze_trace``: the counter pass K1 and the
pricing), the per-site selection (``select_network``) and the network
summary (``network_summary``).

Correctness: one batch of the window, drawn from the seed, is judged
after the window closes. The reference's own float32 forward gives its
operands, held word by word against the program's capture
(``words_differ``), and priced by the reference's counter pass and
pricing: every site's energies from the reference's own words hold the
program's from end to end (``own_energy_gap``). The same counter pass
and pricing run on the program's captured words give the energies, the
selection and the summary the program's must equal exactly (so the stage
from captured words on is held by itself). Every later call on a batch
must repeat the first call's results.
"""
from __future__ import annotations

import time

import torch
from repro_torch import design as D
from repro_torch.apps.cnn import analysis, nets
from repro_torch.kernels import _build

from perfbench.harness import core, inputs
from perfbench.harness.core import Check
from perfbench.reference import sa


class State:
    pass


def setup(run) -> State:
    cfg, tr = run.config, run.traffic
    st = State()
    if run.device.startswith("cuda"):
        _build.build_all(("power_counters",))
    st.batch, st.res = int(tr["batch"]), int(cfg["resolution"])
    st.pool_n = int(tr["pool"])
    st.ref = core.reference(cfg)
    weights, bn = inputs.cnn_params(st.ref.specs(),
                                    inputs.generator(run.seed, run.device, 1))
    st.weights, st.bn = weights, bn
    st.params = nets.Params(weights, bn)
    igen = inputs.generator(run.seed, run.device, 2)
    st.pool = [inputs.images(st.batch, st.res, igen)
               for _ in range(st.pool_n)]
    menu = D.named_designs()
    st.designs = tuple(menu[n] for n in cfg["designs"])
    st.ref_designs = sa.designs(cfg["designs"])
    g = torch.Generator().manual_seed(run.seed)
    st.judged = int(torch.randint(st.pool_n, (1,), generator=g))
    st.kept = None
    st.results = []
    # warm-up: every shape the window runs
    for _ in range(int(tr.get("warm_calls", 1))):
        analyze(run, st, st.pool[0])
    run.sync()
    return st


def analyze(run, st, images):
    """The composed entry on one batch: ``(traces, layers, choices,
    summary)``."""
    if run.fault == "half":            # half of the batch left out
        images = images[:images.shape[0] // 2]
    with run.span("cnn.capture", sync=True):
        traces = nets.forward_with_traces(run.config["net"], images,
                                          params=st.params)
    with run.span("cnn.count_price", sync=True):
        layers = [analysis.analyze_trace(t, designs=st.designs)
                  for t in traces]
        sel = analysis.select_network(layers)
        summary = analysis.network_summary(layers)
    if run.fault == "answer":          # one site's energy altered
        d = layers[len(layers) // 2].designs["proposed"]
        d["total"] = d["total"] * (1.0 + 1e-3)
    return traces, layers, dict(sel.choices), summary


def window(run, st: State) -> None:
    t0 = time.perf_counter()
    i = 0
    while True:
        k = i % st.pool_n
        with run.unit():
            traces, layers, choices, summary = analyze(run, st,
                                                       st.pool[k])
        run.add("attempted")
        st.results.append((k, layers, choices, summary))
        if i == st.judged:
            st.kept = traces
        del traces
        i += 1
        if run.elapsed(t0) >= run.seconds and i > st.judged:
            break
    run.window_s = run.elapsed(t0)
    run.counts["calls"] = i
    run.counts["images"] = i * st.batch


def end_to_end(run, st: State) -> dict:
    return {"images_per_s": run.counts["images"] / run.window_s}


def _rel(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def _summary(per_site: dict) -> dict:
    """``network_summary``'s numbers from per-site design energies."""
    eb = [float(e["baseline"]["energy"]["total"]) for e in per_site.values()]
    ep = [float(e["proposed"]["energy"]["total"]) for e in per_site.values()]
    act = [1.0 - (float(e["proposed"]["h"]) + float(e["proposed"]["v"]))
           / max(float(e["baseline"]["h"]) + float(e["baseline"]["v"]), 1.0)
           for e in per_site.values()]
    zf = [float(e["baseline"]["zero_fraction"]) for e in per_site.values()]
    sav = [1.0 - p / max(b, 1.0) for b, p in zip(eb, ep)]
    return {"overall_power_reduction": 1.0 - sum(ep) / sum(eb),
            "mean_activity_reduction": sum(act) / len(act),
            "mean_zero_fraction": sum(zf) / len(zf),
            "per_layer_saving_min": min(sav),
            "per_layer_saving_max": max(sav)}


def _judge(prog_layers, prog_choices, prog_summary, ref: dict) -> dict:
    """The program's answers against reference energies ``{site:
    {design: price(...)}}``: the widest relative gap of an energy, a
    toggle count or a zero fraction, the sites chosen otherwise, the
    widest relative gap of the summary."""
    gap = 0.0
    for lp in prog_layers:
        r = ref.get(lp.name)
        if r is None:
            return {"energy_gap": float("inf"), "selection_differs": 1e9,
                    "summary_gap": float("inf")}
        for name, d in lp.designs.items():
            e = r[name]
            for key, want in (("total", e["energy"]["total"]),
                              ("streaming", e["energy"]["streaming"]),
                              ("h", e["h"]), ("v", e["v"])):
                gap = max(gap, _rel(float(d[key]), float(want)))
        gap = max(gap, _rel(lp.zero_fraction,
                            float(r["baseline"]["zero_fraction"])))
    choices = sa.select({s: {n: e["energy"] for n, e in ds.items()}
                         for s, ds in ref.items()})
    differs = sum(prog_choices.get(s) != c for s, c in choices.items())
    want = _summary(ref)
    sgap = max(_rel(float(prog_summary[k]), v) for k, v in want.items())
    return {"energy_gap": gap, "selection_differs": float(differs),
            "summary_gap": sgap}


def _mismatch(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a.view(torch.int16) != b.view(torch.int16)).sum())


def check(run, st: State) -> list[Check]:
    lim = run.cell["limits"]
    judged_layers = st.results[st.judged][1]
    first = {}
    repeat = 0.0
    for k, layers, choices, summary in st.results:
        if k not in first:
            first[k] = (layers, choices)
            continue
        l0, c0 = first[k]
        repeat += float(c0 != choices) + sum(
            a.designs != b.designs for a, b in zip(l0, layers))
    images = st.pool[st.results[st.judged][0]]
    st.pool = None
    traces = st.kept
    st.kept = None
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    menu = sa.menu(st.ref_designs)
    dts = (torch.float32, torch.bfloat16) if run.control else (
        torch.float32,)
    ref = [{} for _ in dts]
    own = {}
    diff = {"A": 0, "W": 0}
    total = {"A": 0, "W": 0}
    for (name, A, W), t in zip(st.ref.sites(st.weights, st.bn, images), traces):
        if name != t.name:
            raise RuntimeError(f"site order: reference {name}, program "
                               f"{t.name}")
        for k, want, got in (("A", A, t.A), ("W", W, t.W)):
            total[k] += want.numel()
            diff[k] += _mismatch(got, want)
        own[name] = _price(A, W, menu, st.ref_designs, (torch.float32,))[0]
        del A, W
        for out, ev in zip(ref, _price(t.A, t.W, menu, st.ref_designs, dts)):
            out[name] = ev
    words = max(diff[k] / max(total[k], 1) for k in diff)
    if len(ref[0]) != len(traces) or len(traces) != len(st.ref.specs()):
        words = 1.0
    prog = st.results[st.judged]
    judged = _judge(judged_layers, prog[2], prog[3], ref[0])
    own_gap = _judge(judged_layers, prog[2], prog[3], own)["energy_gap"]
    checks = [Check("words_differ", words, lim["words_differ"]),
              Check("own_energy_gap", own_gap, lim["own_energy_gap"]),
              Check("energy_gap", judged["energy_gap"], lim["energy_gap"]),
              Check("selection_differs", judged["selection_differs"],
                    lim["selection_differs"]),
              Check("summary_gap", judged["summary_gap"], lim["summary_gap"]),
              Check("repeat_differs", repeat, lim["repeat_differs"])]
    if run.control:
        run.control_checks = _control(run, st, images, ref, own, lim)
    return checks


def _price(A, W, menu, designs, dts) -> list[dict]:
    """A site's design evaluations from its operands ``A``, ``W``, one
    for each pricing precision of ``dts``."""
    a_w, b_w = sa.edge_streams(A, W)
    (M, K), N = A.shape, W.shape[1]
    return [sa.evaluate(rep, designs)
            for rep in sa.report(a_w, b_w, M, K, N, menu, dts)]


class _Layer:
    """Evaluations ``{design: ...}`` of one site, in the shape of the
    program's per-site results."""

    def __init__(self, name, ev):
        self.name = name
        self.designs = {n: {"total": e["energy"]["total"],
                            "streaming": e["energy"]["streaming"],
                            "h": e["h"], "v": e["v"]}
                        for n, e in ev.items()}
        self.zero_fraction = float(ev["baseline"]["zero_fraction"])


def _control(run, st, images, ref, own, lim) -> list[Check]:
    """The reference in the next lower precision in the program's place:
    its forward in TF32 (the configuration states float32 with TF32
    off), its pricing in bfloat16 (the program prices in float32)."""
    menu = sa.menu(st.ref_designs)
    diff = {"A": 0, "W": 0}
    total = {"A": 0, "W": 0}
    low_own = {}
    f32 = st.ref.sites(st.weights, st.bn, images)
    low = st.ref.sites(st.weights, st.bn, images, tf32=True)
    for (name, A, W), (_, Al, Wl) in zip(f32, low):
        for k, want, got in (("A", A, Al), ("W", W, Wl)):
            total[k] += want.numel()
            diff[k] += _mismatch(got, want)
        del A, W
        low_own[name] = _price(Al, Wl, menu, st.ref_designs,
                               (torch.bfloat16,))[0]
    words = max(diff[k] / max(total[k], 1) for k in diff)

    def answers(evs):
        layers = [_Layer(n, ev) for n, ev in evs.items()]
        choices = sa.select({s: {n: e["energy"] for n, e in ds.items()}
                             for s, ds in evs.items()})
        return layers, choices, _summary(evs)

    judged = _judge(*answers(ref[1]), ref[0])
    own_gap = _judge(*answers(low_own), own)["energy_gap"]
    return [Check("words_differ", words, lim["words_differ"]),
            Check("own_energy_gap", own_gap, lim["own_energy_gap"]),
            Check("energy_gap", judged["energy_gap"], lim["energy_gap"]),
            Check("selection_differs", judged["selection_differs"],
                  lim["selection_differs"]),
            Check("summary_gap", judged["summary_gap"], lim["summary_gap"])]

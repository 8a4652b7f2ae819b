"""Design-space autotuner: geometry x coding x precision x approx sweeps.

The paper prices one 16x16 bf16 array pair; this module prices a large
grid of :class:`DesignPoint`\\ s -- asymmetric (tall and wide)
geometries, per-precision coding schemes (bf16, fp8-e4m3 and int8, their
segment masks in each format's embedded layout) and an approximate-PE
axis -- against the matmul sites of traced workloads, in ONE
:func:`repro_torch.design.evaluate_batched` call, and reports the
energy-vs-accuracy pareto front.

Pipeline:

1. :func:`collect_sites` traces the workloads (the CNNs and registry LMs
   through :func:`repro_torch.trace.interpret.trace_fn`) and fits every
   matmul site to one common sample shape -- an evenly strided subsample
   (the monitor's estimator) where a site is larger, cyclic tiling where
   it is smaller -- with a per-site weight equal to the full-site/sample
   MAC ratio, so weighted sample energies estimate full-network ones.
2. :func:`sweep_grid` builds the grid; every point's name encodes its
   coordinates (``scheme@precision@RxC[~axNN]``).
3. :func:`build_sweep_report` prices grid x sites (one counter pass per
   ``(geometry, precision)`` group: the counter kernel, K1, on the card),
   computes savings against the conventional bf16 16x16 array and the
   paper's fixed proposed design, and marks the pareto front.

CLI (runs on the card unless ``--device cpu``)::

    python -m repro_torch.design.sweep --quick --device cpu
    python -m repro_torch.design.sweep --json sweep.json --csv sweep.csv
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import monitor
from repro_torch.core import precision as prec
from repro_torch.core.power import DEFAULT_ENERGY, EnergyModel
from repro_torch.core.systolic import SAGeometry

from .evaluate import evaluate_batched
from .point import BIC, NONE, ZVG, ApproxPE, Coding, DesignPoint
from .select import pareto_front

#: default geometry grid: the paper's square, a bigger square, and
#: tall/wide pairs at matched PE counts (256) -- the shapes that move
#: edge dominance (a tall array lengthens the West pipeline and shortens
#: the North one, and vice versa)
GEOMETRIES: tuple[tuple[int, int], ...] = (
    (16, 16), (32, 32), (8, 32), (32, 8), (4, 64), (64, 4),
    (16, 32), (32, 16))

#: reduced grid for smokes (still >= 200 points with the default
#: precision and approx axes)
QUICK_GEOMETRIES: tuple[tuple[int, int], ...] = (
    (16, 16), (32, 32), (8, 32), (32, 8), (4, 64), (64, 4))

PRECISIONS: tuple[str, ...] = ("bf16", "fp8e4m3", "int8")

#: approximate-PE axis: exact, and a 30% multiplier-energy discount at
#: ~2% product relative-RMS error (truncated-partial-product class)
APPROX_LEVELS: tuple[ApproxPE | None, ...] = (None, ApproxPE(0.30, 0.02))

#: grid coordinates of the savings denominators
REFERENCE = "baseline@bf16@16x16"
FIXED = "proposed@bf16@16x16"


def coding_schemes(p: prec.Precision) -> dict[str, tuple[Coding, Coding]]:
    """The coding-scheme menu of one precision: ``name -> (west,
    north)``, segment masks in the format's embedded layout. Formats
    without an exponent field (int8) lack the ``mant-exp`` scheme."""
    mant = p.segments["mantissa"]
    out = {
        "baseline": (NONE, NONE),
        "proposed": (ZVG, BIC(mant)),
        "bic-only": (NONE, BIC(mant)),
        "zvg-only": (ZVG, NONE),
        "bic-west": (BIC(mant, zvg=True), BIC(mant)),
        "full-bus": (ZVG, BIC(p.segments["full"])),
    }
    if "mant_exp" in p.segments:
        out["mant-exp"] = (ZVG, BIC(p.segments["mant_exp"]))
    return out


def point_name(scheme: str, precision: str, geom: SAGeometry,
               approx: ApproxPE | None) -> str:
    name = f"{scheme}@{precision}@{geom.rows}x{geom.cols}"
    if approx is not None and approx.mult_discount:
        name += f"~ax{round(approx.mult_discount * 100)}"
    return name


def sweep_grid(geometries: Sequence[tuple[int, int]] = GEOMETRIES,
               precisions: Sequence[str] = PRECISIONS,
               approx_levels: Sequence[ApproxPE | None] = APPROX_LEVELS,
               energy: EnergyModel = DEFAULT_ENERGY
               ) -> tuple[DesignPoint, ...]:
    """Every geometry x precision x scheme x approx-level combination,
    uniquely named. The defaults give ``8 * (7 + 7 + 6) * 2 = 320``
    points."""
    pts = []
    for r, c in geometries:
        geom = SAGeometry(r, c)
        for pname in precisions:
            p = prec.get(pname)
            for scheme, (west, north) in coding_schemes(p).items():
                for ax in approx_levels:
                    pts.append(DesignPoint(
                        point_name(scheme, pname, geom, ax),
                        west=west, north=north, geometry=geom,
                        energy=energy, precision=pname, approx=ax))
    return tuple(pts)


# ------------------------------------------------------------- site capture
@dataclasses.dataclass
class SweepSites:
    """Traced matmul sites fitted to one common sample shape."""
    A: torch.Tensor          # [B, Ms, Ks] bf16 sampled inputs
    W: torch.Tensor          # [B, Ks, Ns] bf16 sampled weights
    weights: torch.Tensor    # [B] float32 full-site / sample MAC ratios
    names: list[str]         # "<model>:<site>"
    sample: tuple[int, int, int]


def _fit_axis(x: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    """Fit one axis to ``target``: the monitor's evenly strided subsample
    (spanning the whole axis) when larger, cyclic tiling when smaller.
    Tiling repeats real operand statistics where zero padding would fake
    a zero-rich stream; the repeated transitions are an approximation of
    the small sites it applies to."""
    n = x.shape[axis]
    if n == target:
        return x
    if n > target:
        return monitor._subsample(x, target, axis)
    reps = -(-target // n)
    return torch.cat([x] * reps, dim=axis).narrow(axis, 0, target)


def collect_sites(nets: Sequence[str] = ("resnet50",),
                  archs: Sequence[str] = ("qwen1.5-0.5b",),
                  *, res: int = 64, seq: int = 16, batch: int = 2,
                  sample: tuple[int, int, int] = (96, 96, 96),
                  seed: int = 0, device="cuda",
                  params: dict | None = None) -> SweepSites:
    """Trace the workloads and collect every matmul site's operands.

    Each site contributes batch element 0 of its ``[B, M, K] x [B, K,
    N]`` operands fitted to ``sample = (Ms, Ks, Ns)`` (the K fit uses the
    same index map on both operands, so the streamed K sequences stay
    aligned), in bfloat16, with weight ``B * M * K * N / (Ms * Ks *
    Ns)``: energy is extensive in MACs, so the weighted sample total
    estimates the full network. One common shape lets the whole grid
    price every site in one batched pass.

    The CNNs run on the JAX package's numpy draws (weights from ``seed``,
    one image at ``res`` px); the LMs at their smoke configs, as the JAX
    package traces them, with random float32 masters from ``seed`` or
    ``params[arch]`` (the port's tree, e.g. converted from the JAX
    package's). Runs on the card unless ``device`` says otherwise.
    """
    from repro_torch.apps import check_device
    from repro_torch.apps.cnn import nets as cnn_nets
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.trace.interpret import trace_fn
    from repro_torch.trace.sweep import model_inputs

    device = check_device(device, "collect_sites")
    params = params or {}
    Ms, Ks, Ns = sample
    As, Ws, wts, names = [], [], [], []

    def emit_for(model: str):
        def emit(site):
            b, m, k, n = site.shape
            a = _fit_axis(_fit_axis(site.lhs[0], Ms, 0), Ks, 1)
            w = _fit_axis(_fit_axis(site.rhs[0], Ks, 0), Ns, 1)
            As.append(a.to(torch.bfloat16))
            Ws.append(w.to(torch.bfloat16))
            wts.append(float(b) * m * k * n / float(Ms * Ks * Ns))
            names.append(f"{model}:{site.name}")
        return emit

    with torch.no_grad():
        for net in nets:
            fwd = cnn_nets.make_forward(net, seed=seed)
            images = cnn_nets.synthetic_images(1, res=res, seed=seed + 7,
                                               device=device)
            trace_fn(fwd, images, emit=emit_for(net), name=net)
        for arch in archs:
            acfg = get_config(arch, smoke=True)
            p = params.get(arch)
            if p is None:
                gen = torch.Generator(device=device).manual_seed(seed)
                p = lm.init_model(acfg, gen)
            weights = lm.compute_weights(p, acfg)
            tokens = model_inputs(acfg, batch, seq, seed, device)["tokens"]

            def fn(w, toks, acfg=acfg):
                return lm.logits_fn(w, acfg, lm.apply_model(w, acfg,
                                                            toks)[0])
            trace_fn(fn, weights, tokens, emit=emit_for(arch), name=arch)
    if not As:
        raise ValueError("no matmul sites traced (empty nets AND archs?)")
    return SweepSites(A=torch.stack(As), W=torch.stack(Ws),
                      weights=torch.tensor(wts, dtype=torch.float32),
                      names=names, sample=(Ms, Ks, Ns))


# ------------------------------------------------------------------- report
@dataclasses.dataclass
class SweepReport:
    """Priced grid and pareto front over the traced sites."""
    rows: list[dict]            # one dict per design point, grid order
    front: list[int]            # row indices of the pareto front
    beats_fixed: list[str]      # non-square/sub-bf16 points cheaper than
                                # the fixed design on streaming energy
    reference: str
    fixed: str
    n_sites: int
    site_names: list[str]
    sample: tuple[int, int, int]

    def front_rows(self) -> list[dict]:
        return sorted((self.rows[i] for i in self.front),
                      key=lambda r: r["accuracy_proxy"])

    # ---------------------------------------------------- serialization
    def to_json_dict(self) -> dict:
        return {
            "reference": self.reference,
            "fixed": self.fixed,
            "n_points": len(self.rows),
            "n_sites": self.n_sites,
            "sample": list(self.sample),
            "front": [self.rows[i]["name"] for i in self.front],
            "beats_fixed_streaming": list(self.beats_fixed),
            "site_names": list(self.site_names),
            "rows": self.rows,
        }

    def to_json(self, path: str) -> None:
        from repro_torch.trace.report import write_json
        write_json(path, self.to_json_dict())

    def to_csv(self, path: str) -> None:
        from repro_torch.trace.report import write_csv
        cols = ("name", "scheme", "precision", "rows", "cols",
                "approx_discount", "accuracy_proxy", "energy_total",
                "energy_streaming", "cycles", "saving_total",
                "saving_streaming", "streaming_vs_fixed", "on_front")
        write_csv(path, cols, [[r[c] for c in cols] for r in self.rows])

    # ------------------------------------------------------------- text
    def table(self, max_rows: int = 24) -> str:
        hdr = (f"{'design':34s} {'acc-proxy':>9s} {'energy(fJ)':>13s} "
               f"{'save%':>6s} {'stream-save%':>12s} {'vs-fixed%':>9s}")
        lines = [f"pareto front ({len(self.front)} of {len(self.rows)} "
                 f"points, {self.n_sites} sites; energy vs "
                 f"accuracy-proxy, both minimized):", hdr,
                 "-" * len(hdr)]
        for r in self.front_rows()[:max_rows]:
            lines.append(
                f"{r['name']:34s} {r['accuracy_proxy']:9.4f} "
                f"{r['energy_total']:13.4g} {r['saving_total']*100:6.1f} "
                f"{r['saving_streaming']*100:12.1f} "
                f"{r['streaming_vs_fixed']*100:9.1f}")
        fixed = next(r for r in self.rows if r["name"] == self.fixed)
        lines.append("-" * len(hdr))
        lines.append(
            f"fixed design {self.fixed}: saving "
            f"{fixed['saving_total']*100:.1f}% | "
            f"{len(self.beats_fixed)} non-square/sub-bf16 points beat it "
            f"on streaming energy")
        if self.beats_fixed:
            lines.append("  e.g. " + ", ".join(self.beats_fixed[:4]))
        return "\n".join(lines)


def build_sweep_report(sites: SweepSites,
                       designs: Sequence[DesignPoint],
                       backend: str | None = None,
                       reference: str = REFERENCE,
                       fixed: str = FIXED) -> SweepReport:
    """Price the whole grid over the traced sites -- ONE
    :func:`evaluate_batched` call -- and assemble the pareto report.

    ``reference`` (the conventional bf16 16x16 array) is the savings
    denominator; ``fixed`` (the paper's proposed design) is the target of
    the "does widening the design space beat the paper's fixed choice"
    column. Both must be in the grid. ``backend`` picks the counter pass
    (bit-identical counters either way).
    """
    designs = tuple(designs)
    byname = {d.name: d for d in designs}
    for needed in (reference, fixed):
        if needed not in byname:
            raise ValueError(
                f"design grid must contain {needed!r} (the savings "
                f"denominator / fixed comparison); got "
                f"{len(designs)} points without it")
    ev = evaluate_batched(sites.A, sites.W, designs, backend=backend,
                          weights=sites.weights)
    ref_total = max(float(ev[reference]["energy"]["total"]), 1e-30)
    ref_stream = max(float(ev[reference]["energy"]["streaming"]), 1e-30)
    fixed_stream = max(float(ev[fixed]["energy"]["streaming"]), 1e-30)

    rows = []
    for d in designs:
        e = ev[d.name]["energy"]
        total, stream = float(e["total"]), float(e["streaming"])
        rows.append({
            "name": d.name,
            "scheme": d.name.split("@", 1)[0],
            "precision": d.precision,
            "rows": d.geometry.rows,
            "cols": d.geometry.cols,
            "approx_discount": (d.approx.mult_discount if d.approx
                                else 0.0),
            "accuracy_proxy": d.accuracy_proxy,
            "energy_total": total,
            "energy_streaming": stream,
            "cycles": float(ev[d.name]["cycles"]),
            "saving_total": 1.0 - total / ref_total,
            "saving_streaming": 1.0 - stream / ref_stream,
            "streaming_vs_fixed": 1.0 - stream / fixed_stream,
            "on_front": False,
        })
    front = pareto_front([(r["energy_total"], r["accuracy_proxy"])
                          for r in rows])
    for i in front:
        rows[i]["on_front"] = True
    beats = [r["name"] for r in rows
             if r["energy_streaming"] < fixed_stream
             and (r["precision"] != "bf16" or r["rows"] != r["cols"])]
    return SweepReport(rows=rows, front=front, beats_fixed=beats,
                       reference=reference, fixed=fixed,
                       n_sites=len(sites.names),
                       site_names=sites.names, sample=sites.sample)


# ---------------------------------------------------------------------- CLI
def main(argv: Sequence[str] | None = None) -> None:
    import argparse

    from repro_torch.kernels.power_counters.ops import BACKENDS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.design.sweep",
        description="Price a geometry x coding x precision x approx "
                    "design grid over traced workloads and report the "
                    "energy/accuracy pareto front.")
    ap.add_argument("--nets", default="resnet50",
                    help="comma-separated CNNs to trace ('' for none)")
    ap.add_argument("--archs", default="qwen1.5-0.5b",
                    help="comma-separated registry LMs ('' for none)")
    ap.add_argument("--res", type=int, default=64,
                    help="CNN input resolution")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--sample", default="96x96x96",
                    help="common site sample shape MsxKsxNs")
    ap.add_argument("--geometries", default="",
                    help="comma-separated RxC list (default: the "
                         "built-in 8-geometry grid)")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="counter pass: the Hopper kernel on the card "
                         "(auto, cuda) or the plain version (ref)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda by default; cpu runs "
                         "the plain versions)")
    ap.add_argument("--quick", action="store_true",
                    help="CNN-only sites, smaller sample, 6-geometry "
                         "grid (still >= 200 points)")
    ap.add_argument("--json", default="", help="write the report JSON")
    ap.add_argument("--csv", default="", help="write the per-point CSV")
    ap.add_argument("--max-rows", type=int, default=24)
    args = ap.parse_args(argv)

    nets = tuple(n for n in args.nets.split(",") if n)
    archs = tuple(a for a in args.archs.split(",") if a)
    sample = tuple(int(v) for v in args.sample.split("x"))
    if len(sample) != 3:
        ap.error(f"--sample must be MsxKsxNs, got {args.sample!r}")
    if args.geometries:
        try:
            geoms = tuple(tuple(int(v) for v in g.split("x"))
                          for g in args.geometries.split(","))
            if any(len(g) != 2 for g in geoms):
                raise ValueError
        except ValueError:
            ap.error(f"--geometries must be RxC[,RxC...], got "
                     f"{args.geometries!r}")
        if (16, 16) not in geoms:
            geoms = ((16, 16),) + geoms   # the reference pair lives here
    elif args.quick:
        geoms = QUICK_GEOMETRIES
    else:
        geoms = GEOMETRIES
    if args.quick:
        archs = ()
        sample = tuple(min(s, 64) for s in sample)

    designs = sweep_grid(geometries=geoms)
    print(f"grid: {len(designs)} design points "
          f"({len(geoms)} geometries x {len(PRECISIONS)} precisions x "
          f"coding schemes x {len(APPROX_LEVELS)} approx levels)")
    sites = collect_sites(nets=nets, archs=archs, res=args.res,
                          seq=args.seq, batch=args.batch, sample=sample,
                          device=args.device)
    print(f"sites: {len(sites.names)} traced matmuls fitted to "
          f"{sample[0]}x{sample[1]}x{sample[2]} samples")
    rep = build_sweep_report(sites, designs, backend=args.backend)
    print(rep.table(max_rows=args.max_rows))
    if args.json:
        rep.to_json(args.json)
        print(f"wrote {args.json}")
    if args.csv:
        rep.to_csv(args.csv)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()

"""Per-request streaming-power accounting for the serving engine.

What does the paper's BIC + ZVG save per served request, over the
operand streams that request produced: its own prompt at prefill and its
own tokens at every decode step? The engine hands the accountant one
(activations, weight) pair per monitored site -- the request's embedded
prompt rows at admission (:meth:`PowerAccountant.record_prefill`, priced
by :func:`repro_torch.core.monitor.stream_counters`, whose counter pass
is K1), and per sampled decode step the ``[B, K]`` embedded decode
inputs, one row per slot (:meth:`PowerAccountant.record_decode`).

Decode counters come from one of two producers, which emit the same
integers: the fused matmul+counter kernel (K3) through
:func:`repro_torch.kernels.zvg_matmul.fused_matmul_counters`, or the
plain producer :func:`_ref_decode_counters` through the counter pass. Both
feed the ONE float assembler :func:`_assemble_decode`, so the two give
bit-identical energies by construction. Live slots' rows are credited to
the request in the slot, scaled to the full operand extent. Retirement
freezes the sums into a :class:`RequestPowerReport` (energies before
ratios) and books the same per-site counters into a
:class:`repro_torch.trace.capture.TraceCapture`, so request energies add
up to the serve-wide report exactly.

With ``sample_every = k`` only every k-th decode step is streamed;
retirement extrapolates decode energies by ``steps / sampled_steps``.

Retirement also hands a :class:`RetirementRecord` -- the same per-site
floats it books -- to every hook in ``PowerAccountant.retire_hooks``
(the windowed telemetry of :mod:`repro_torch.serve.telemetry`). With
:meth:`PowerAccountant.enable_actuation` each site is priced under its
active design, which :meth:`PowerAccountant.apply_swaps` changes between
engine steps: recordings carry the design of their swap epoch, and
retirement adds an ``"actuated"`` energy entry pricing each epoch under
its own design.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import monitor, systolic
from repro_torch.core.bits import to_bits
from repro_torch.design.evaluate import design_energy, menu_args
from repro_torch.kernels import power_counters as pc
from repro_torch.kernels.power_counters.ops import BACKENDS
from repro_torch.kernels.zvg_matmul import fused_matmul_counters
from repro_torch.kernels.zvg_matmul.ref import pad_lanes as _pad_lanes
from repro_torch.runtime.spmd import local
from repro_torch.trace.capture import CaptureConfig, TraceCapture

#: the pseudo-design that prices each recording under the design that
#: was active when it was made (closed-loop actuation,
#: :mod:`repro_torch.serve.telemetry`); it rides the report machinery
#: as design selection's "selected" does
ACTUATED = "actuated"

#: components an actuated pricing carries: the monitor's energy
#: components and the h/v pipeline toggles trace reports quote
ACTUATED_COMPONENTS = monitor.COMPONENTS + ("h", "v")


def _epoch_energy(design: str, counters: dict) -> dict[str, float]:
    """Price one swap epoch's counter sub-sums under its design."""
    comps = monitor.counters_to_energy(dict(counters)).get(design, {})
    out = {c: float(comps.get(c, 0.0)) for c in monitor.COMPONENTS}
    out["h"] = float(counters.get(f"h/{design}", 0.0))
    out["v"] = float(counters.get(f"v/{design}", 0.0))
    return out


def actuated_site_energy(record: "SiteRecord",
                         primary: str) -> dict[str, float]:
    """Price one frozen site record as recorded: each swap epoch's
    counter sub-sums under the design active when they were recorded (a
    request that spans a swap pays the old design before it and the new
    one after). The live accountant and every offline consumer share
    this function and its float-addition order, so replays reproduce
    actuated energies bit for bit. Records without epochs (schema-v1
    dumps) price entirely under ``primary``."""
    epochs = record.epochs or ((primary, record.counters),)
    total: dict[str, float] | None = None
    for design, counters in epochs:
        e = _epoch_energy(design, counters)
        if total is None:
            total = e
        else:
            for c in total:
                total[c] += e[c]
    return total if total is not None else dict.fromkeys(
        ACTUATED_COMPONENTS, 0.0)


def actuated_stream_energy(records, primary: str) -> float:
    """Total actuated energy (fJ) of a retirement-record stream: the
    (site, active design) counter sub-sums are merged across the stream
    first, then priced -- the grouping of the selector's fixed and online
    window tracks, so on a stream without swaps the actuated total equals
    the fixed primary's bit for bit."""
    by_site: dict[str, dict[str, dict[str, float]]] = {}
    for rec in records:
        for sr in rec.sites:
            site = by_site.setdefault(sr.site, {})
            for design, counters in sr.epochs or ((primary, sr.counters),):
                sub = site.setdefault(design, {})
                for k, v in counters.items():
                    if k == "zero_fraction":
                        continue
                    sub[k] = sub.get(k, 0.0) + float(v)
    total = 0.0
    for designs in by_site.values():
        for design, counters in designs.items():
            total += float(monitor.counters_to_energy(counters)
                           .get(design, {}).get("total", 0.0))
    return total


def gather_local(a):
    """The operand as a plain tensor on the accountant's device: a
    DTensor of a mesh engine is gathered to its full value (the JAX
    package's ``device_get``), so the counters see operands bitwise the
    single-device engine's; a plain tensor passes as it is."""
    return local(a)


def fused_decode_supported(mcfg: monitor.MonitorConfig) -> bool:
    """Whether the producer/assembler split prices this config: ONE
    stream geometry and bfloat16 words (the default paper pair). Other
    menus take :func:`_rows_counters`."""
    groups = menu_args(mcfg.design_list)
    return len(groups) == 1 and next(iter(groups))[1] == "bf16"


def _decode_menu(mcfg: monitor.MonitorConfig):
    """``(geometry, menu kwargs, west CounterSpec, north CounterSpec)`` of
    a single-geometry config."""
    ((geom, _), kw), = menu_args(mcfg.design_list).items()
    return (geom, kw,
            pc.CounterSpec(bic_variants=kw["west_bic"], zvg=kw["west_zvg"]),
            pc.CounterSpec(bic_variants=kw["north_bic"],
                           zvg=kw["north_zvg"]))


def _subsample_decode(A: torch.Tensor, W: torch.Tensor,
                      mcfg: monitor.MonitorConfig):
    """The per-row ``subsample_operands`` for a whole batch: the strided
    take along each axis commutes with the rows."""
    A2 = monitor._subsample(A, mcfg.max_depth, 1)
    W2 = monitor._subsample(
        monitor._subsample(W, mcfg.max_depth, 0), mcfg.max_cols, 1)
    return A2, W2


def _ref_decode_counters(A: torch.Tensor, W: torch.Tensor,
                         mcfg: monitor.MonitorConfig):
    """Plain counter producer: the decode streams' per-lane counters
    through the counter pass (``mcfg.backend``): one west stream per
    request row, the row's words in lane 0 of ``rows`` lanes, and the
    north stream of the weights padded to a multiple of ``cols`` lanes.
    Returns ``(west_counts int32[B, n_rows_w, R], west_rowzeros
    int32[B, K], north_counts int32[n_rows_n, Np], north_rowzeros
    int32[K])``, the fused producer's contract."""
    geom, _, wspec, nspec = _decode_menu(mcfg)
    A2, W2 = _subsample_decode(A, W, mcfg)
    lanes_n = -(-W2.shape[1] // geom.cols) * geom.cols
    nrows = pc.edge_counters(_pad_lanes(to_bits(W2), lanes_n), nspec,
                             backend=mcfg.backend)
    x_w = torch.zeros(A2.shape + (geom.rows,), dtype=torch.int32,
                      device=A2.device)
    x_w[..., 0] = to_bits(A2)
    wrows = pc.edge_counters(x_w, wspec, backend=mcfg.backend)
    return (torch.stack([wrows[n] for n in wspec.rows], dim=1),
            wrows["rowzeros"],
            torch.stack([nrows[n] for n in nspec.rows]), nrows["rowzeros"])


def _fused_decode_counters(A: torch.Tensor, W: torch.Tensor,
                           mcfg: monitor.MonitorConfig, backend: str):
    """Fused counter producer: ONE pass (K3 on the card) emits the gated
    decode products and the same counters as :func:`_ref_decode_counters`.
    Returns ``(wc, wz, nc, nz, product)``."""
    geom, _, wspec, nspec = _decode_menu(mcfg)
    A2, W2 = _subsample_decode(A, W, mcfg)
    product, wc, wz, nc, nz = fused_matmul_counters(
        A2, W2, wspec, nspec, geom.rows, geom.cols, backend)
    return wc, wz, nc, nz, product


def _assemble_decode(wc, wz, nc, nz, mcfg: monitor.MonitorConfig,
                     ns: int) -> dict:
    """Price the per-lane counters of a decode batch into per-row flat
    counters (``{key: float32[B]}``, the :func:`monitor.stream_counters`
    contract for each row). The one float assembly both producers feed.
    ``ns`` is the sub-sampled weight-column count (the unpadded N of the
    stream facts)."""
    geom, kw, wspec, nspec = _decode_menu(mcfg)
    B, K = wz.shape
    menu = systolic.menu_lane_sums(
        {name: wc[:, i] for i, name in enumerate(wspec.rows)}, "w",
        kw["west_bic"], kw["west_zvg"])
    menu.update(systolic.menu_lane_sums(
        {name: nc[i] for i, name in enumerate(nspec.rows)}, "n",
        kw["north_bic"], kw["north_zvg"]))
    menu.update(systolic.stream_facts(geom, 1, K, ns, wz,
                                      nz.expand(B, K)))
    ev = {d.name: design_energy(menu, d) for d in mcfg.design_list}
    flat = monitor.flatten_evaluated(ev, mcfg.design_names)
    return {k: torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32),
                                  (B,))
            for k, v in flat.items()}


def _rows_counters(A: torch.Tensor, W: torch.Tensor,
                   mcfg: monitor.MonitorConfig) -> dict:
    """Per-row flat counters for menus the split does not price (several
    geometries or precisions): each row streamed on its own."""
    per = [monitor.stream_counters(
               *monitor.subsample_operands(a[None], W, mcfg), mcfg)
           for a in A]
    return {k: torch.tensor([float(p[k]) for p in per]) for k in per[0]}


@dataclasses.dataclass(frozen=True)
class SiteRecord:
    """One monitored site's frozen share of one retired request: the
    ``(site, kind, shape, counters)`` the accountant books into the
    serve-wide capture at retirement -- the same floats in the same
    order -- so replaying site records through ``record_counters``
    reproduces the capture bit for bit."""
    site: str
    kind: str
    shape: tuple[int, ...]
    counters: dict           # flat counters with "zero_fraction"
    #: the swap-epoch split of ``counters``: ``((design, sub_counters),
    #: ...)``, each sub-dict the recordings made while that design was
    #: the site's active choice, summed in the float-addition order of
    #: ``counters`` (one epoch's floats equal ``counters`` bit for bit).
    #: Empty on records dumped before actuation existed (schema v1).
    epochs: tuple = ()

    def to_json_dict(self) -> dict:
        return {"site": self.site, "kind": self.kind,
                "shape": list(self.shape), "counters": dict(self.counters),
                "epochs": [[d, dict(c)] for d, c in self.epochs]}

    @classmethod
    def from_json_dict(cls, d: dict) -> "SiteRecord":
        return cls(site=d["site"], kind=d["kind"],
                   shape=tuple(d["shape"]), counters=dict(d["counters"]),
                   epochs=tuple((e[0], dict(e[1]))
                                for e in d.get("epochs", [])))


@dataclasses.dataclass(frozen=True)
class RetirementRecord:
    """What one retirement adds to the serve-wide accounting, as plain
    data: the unit the windowed telemetry registry partitions. Handed to
    every hook in ``PowerAccountant.retire_hooks`` once its counters are
    booked into the capture, so window sums and ``trace_report()`` are
    two views of one retirement stream."""
    uid: int
    prompt_tokens: int
    new_tokens: int
    decode_steps: int
    sampled_steps: int
    sites: tuple[SiteRecord, ...]

    def to_json_dict(self) -> dict:
        return {"uid": self.uid, "prompt_tokens": self.prompt_tokens,
                "new_tokens": self.new_tokens,
                "decode_steps": self.decode_steps,
                "sampled_steps": self.sampled_steps,
                "sites": [s.to_json_dict() for s in self.sites]}

    @classmethod
    def from_json_dict(cls, d: dict) -> "RetirementRecord":
        return cls(uid=d["uid"], prompt_tokens=d["prompt_tokens"],
                   new_tokens=d["new_tokens"],
                   decode_steps=d["decode_steps"],
                   sampled_steps=d["sampled_steps"],
                   sites=tuple(SiteRecord.from_json_dict(s)
                               for s in d["sites"]))


@dataclasses.dataclass
class RequestPowerReport:
    """Frozen power outcome of one retired request (energies in fJ,
    extrapolated to the full operand extent and all decode steps)."""
    uid: int
    prompt_tokens: int
    new_tokens: int
    decode_steps: int          # decode steps this request was live for
    sampled_steps: int         # of which were streamed through the model
    energy: dict               # {design name: {component: fJ}}
    zero_fraction: float       # mean over sampled (site, step) records
    sites: tuple[str, ...]     # monitored site names
    reference: str = "baseline"   # savings denominator design
    primary: str = "proposed"     # headline design

    def saving(self, design: str, component: str = "total") -> float:
        b = self.energy[self.reference][component]
        return 1.0 - self.energy[design][component] / max(b, 1e-30)

    @property
    def saving_total(self) -> float:
        return self.saving(self.primary)

    @property
    def saving_streaming(self) -> float:
        return self.saving(self.primary, "streaming")

    @property
    def streaming_share(self) -> float:
        return (self.energy[self.reference]["streaming"]
                / max(self.energy[self.reference]["total"], 1e-30))

    def summary(self) -> dict:
        return {
            "prompt_tokens": self.prompt_tokens,
            "new_tokens": self.new_tokens,
            "sampled_steps": self.sampled_steps,
            "saving_total": self.saving_total,
            "saving_streaming": self.saving_streaming,
            "streaming_share": self.streaming_share,
            "zero_fraction": self.zero_fraction,
            "energy_base_fj": self.energy[self.reference]["total"],
            "energy_prop_fj": self.energy[self.primary]["total"],
            "design_savings": {d: self.saving(d) for d in self.energy
                               if d != self.reference},
        }


class _SiteRec:
    """Summed flat counters for one (slot, site), plus the site's operand
    shape ``(B, M, K, N)`` so retirement books honest MAC counts."""

    def __init__(self, shape: tuple[int, int, int, int]):
        self.shape = shape
        self.counters: dict[str, float] = {}
        # design -> the counters added while it was the site's active
        # design (swap epochs), summed in the order of ``counters``: a
        # life under one design has ``counters`` bit for bit here
        self.priced: dict[str, dict[str, float]] = {}
        self.zf_sum = 0.0
        self.zf_n = 0

    def add(self, counters: dict, zf: float, design: str):
        sub = self.priced.setdefault(design, {})
        for k, v in counters.items():
            self.counters[k] = self.counters.get(k, 0.0) + v
            sub[k] = sub.get(k, 0.0) + v
        self.zf_sum += zf
        self.zf_n += 1

    @property
    def zf_mean(self) -> float:
        return self.zf_sum / max(self.zf_n, 1)


class _SlotAcc:
    """Mutable per-slot accumulator while its request is live."""

    def __init__(self, uid: int, prompt_tokens: int):
        self.uid = uid
        self.prompt_tokens = prompt_tokens
        self.decode_steps = 0
        self.sampled_steps = 0
        self.due = False           # current step is sampled for this slot
        self.prefill: dict[str, _SiteRec] = {}
        self.decode: dict[str, _SiteRec] = {}


class PowerAccountant:
    """Per-slot incremental accounting, one live request per slot.

    ``kernel_backend`` picks the kernels of the accounting as of the whole
    serving path: ``"auto"`` runs the Hopper kernels on CUDA tensors
    (decode counters by K3, prefill counters by the monitor's counter
    backend, K1 by default) and the plain versions on CPU tensors;
    ``"cuda"`` and ``"ref"`` force the kernels or the plain versions for
    both, ``"ref"`` with the plain decode producer.

    ``retire_hooks`` receive each retirement's :class:`RetirementRecord`
    after its counters are booked. :meth:`enable_actuation` turns on the
    per-site active designs of :meth:`apply_swaps` and the
    ``"actuated"`` energies.
    """

    def __init__(self, mcfg: monitor.MonitorConfig = monitor.DEFAULT_MONITOR,
                 sample_every: int = 1, kernel_backend: str = "auto"):
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1: {sample_every}")
        if kernel_backend not in BACKENDS:
            raise ValueError(f"unknown kernel_backend {kernel_backend!r}; "
                             f"expected one of {BACKENDS}")
        if kernel_backend != "auto":
            mcfg = dataclasses.replace(mcfg, backend=kernel_backend)
        self.mcfg = mcfg
        self.sample_every = sample_every
        self.kernel_backend = kernel_backend
        self._split = fused_decode_supported(mcfg)
        self._fused = kernel_backend != "ref" and self._split
        self._global_step = 0
        self._slots: dict[int, _SlotAcc] = {}
        # serve-wide registry (paper-style report over ALL traffic)
        self.capture = TraceCapture(CaptureConfig(monitor=mcfg))
        # each called with every retirement's record, after its counters
        # were booked into the capture (the telemetry registry's feed)
        self.retire_hooks: list = []
        # closed-loop actuation: the per-site active design (full
        # "prefill/..."/"decode/..." names; absent sites price under the
        # primary), the swap epochs, and the actuated totals -- request
        # major (retirement order, the sum of the requests' actuated
        # energies bit for bit) and site major (for trace reports)
        self.actuation_enabled = False
        self.swap_epoch = 0
        self._site_design: dict[str, str] = {}
        self.swap_log: list[tuple[int, dict[str, str]]] = []
        self._act_totals: dict[str, float] = dict.fromkeys(
            ACTUATED_COMPONENTS, 0.0)
        self._act_sites: dict[str, dict[str, float]] = {}

    # ----------------------------------------------------------- actuation
    def enable_actuation(self) -> None:
        """Price every recording under the design active when it is made:
        each retirement gains an ``"actuated"`` energy entry, and
        :meth:`apply_swaps` becomes legal. Enable before any traffic so
        the actuated track covers every retired request."""
        if ACTUATED in self.mcfg.design_names:
            raise ValueError(
                f"design name {ACTUATED!r} is reserved for the actuated "
                f"pricing track; rename the configured design")
        self.actuation_enabled = True

    def design_for(self, site: str) -> str:
        """The design now pricing ``site`` (its full ``prefill/...`` or
        ``decode/...`` name)."""
        return self._site_design.get(site, self.mcfg.primary_design)

    def apply_swaps(self, mapping: dict[str, str]) -> int:
        """Swap the active design of the given sites (full site name ->
        design) at once. Host bookkeeping only, between engine steps:
        recordings already made keep their design, later ones price under
        the new one. Returns the swap epoch, unchanged when nothing
        changes."""
        if not self.actuation_enabled:
            raise RuntimeError(
                "apply_swaps requires enable_actuation() first")
        known = set(self.mcfg.design_names)
        bad = sorted(set(mapping.values()) - known)
        if bad:
            raise KeyError(f"unknown designs in swap: {bad}; "
                           f"configured: {sorted(known)}")
        changed = {s: d for s, d in mapping.items()
                   if self.design_for(s) != d}
        if not changed:
            return self.swap_epoch
        self.swap_epoch += 1
        self._site_design.update(changed)
        self.swap_log.append((self.swap_epoch, changed))
        return self.swap_epoch

    def actuated_totals(self) -> dict[str, float]:
        """Serve-wide actuated energy components, summed request by
        request: bit for bit the sum of every retired request's
        ``energy["actuated"]`` in retirement order."""
        return dict(self._act_totals)

    def inject_actuated(self, report) -> None:
        """Add the ``"actuated"`` pseudo-design to a serve-wide
        :class:`repro_torch.trace.report.TraceReport` in place, from the
        site-major actuated sums (the floats of the per-request reports,
        grouped by site in retirement order)."""
        if not self.actuation_enabled:
            return
        for s in report.sites:
            tot = self._act_sites.get(
                s.name, dict.fromkeys(ACTUATED_COMPONENTS, 0.0))
            s.designs[ACTUATED] = {"total": tot["total"],
                                   "streaming": tot["streaming"],
                                   "h": tot["h"], "v": tot["v"]}
        if ACTUATED not in report.designs:
            report.designs = tuple(report.designs) + (ACTUATED,)

    # ----------------------------------------------------------- lifecycle
    def begin(self, slot: int, uid: int, prompt_tokens: int) -> None:
        self._slots[slot] = _SlotAcc(uid, prompt_tokens)

    def suspend(self, slot: int) -> _SlotAcc:
        """Detach a preempted request's accumulator without booking it:
        nothing reaches the serve-wide capture until the request retires,
        so preemption neither counts twice nor loses energy. Hand it back
        with :meth:`resume` at re-admission."""
        return self._slots.pop(slot)

    def resume(self, slot: int, acc: _SlotAcc) -> None:
        """Re-attach a suspended accumulator to the request's new slot;
        the re-prefill of prompt and generated tokens then adds to its
        sums (recomputed K/V is energy spent)."""
        if slot in self._slots:
            raise RuntimeError(f"slot {slot} already accounted")
        self._slots[slot] = acc

    def finish(self, slot: int, new_tokens: int) -> RequestPowerReport:
        """Freeze the slot's sums into a report AND book the same frozen,
        extrapolated per-site counters into the serve-wide capture."""
        return self.finish_detached(self._slots.pop(slot), new_tokens)

    def finish_detached(self, acc: _SlotAcc,
                        new_tokens: int) -> RequestPowerReport:
        """Freeze an accumulator directly: the one retirement path, also
        for a request cancelled while preempted (real energy, no slot)."""
        scale = acc.decode_steps / max(acc.sampled_steps, 1)
        total: dict[str, float] = {}
        zf_sum = zf_n = 0.0
        site_records: list[SiteRecord] = []
        for site, rec in acc.prefill.items():
            for k, v in rec.counters.items():
                total[k] = total.get(k, 0.0) + v
            zf_sum += rec.zf_sum
            zf_n += rec.zf_n
            site_records.append(SiteRecord(
                site, "dot_general", rec.shape,
                {**rec.counters, "zero_fraction": rec.zf_mean},
                epochs=tuple((d, dict(sub))
                             for d, sub in rec.priced.items())))
        for site, rec in acc.decode.items():
            scaled = {k: v * scale for k, v in rec.counters.items()}
            for k, v in scaled.items():
                total[k] = total.get(k, 0.0) + v
            zf_sum += rec.zf_sum
            zf_n += rec.zf_n
            # MACs extrapolate with the energies: all decode steps count
            shape = (acc.decode_steps,) + rec.shape[1:]
            site_records.append(SiteRecord(
                site, "dot_general", shape,
                {**scaled, "zero_fraction": rec.zf_mean},
                # epoch sub-sums extrapolate as the totals do: the same
                # float scaled by the same factor
                epochs=tuple((d, {k: v * scale for k, v in sub.items()})
                             for d, sub in rec.priced.items())))
        # one frozen record set, booked into the capture and handed to
        # every hook: the serve-wide report and any windowed view sum the
        # same floats
        for sr in site_records:
            self.capture.record_counters(sr.site, sr.kind, sr.shape,
                                         sr.counters)
        retirement = RetirementRecord(
            uid=acc.uid, prompt_tokens=acc.prompt_tokens,
            new_tokens=new_tokens, decode_steps=acc.decode_steps,
            sampled_steps=acc.sampled_steps, sites=tuple(site_records))
        for hook in self.retire_hooks:
            hook(retirement)
        energy = monitor.counters_to_energy(total)
        # every configured design, all-zero for a request that retired
        # with no sampled records
        for name in self.mcfg.design_names:
            comps = energy.setdefault(name, {})
            for c in monitor.COMPONENTS:
                comps.setdefault(c, 0.0)
        if self.actuation_enabled:
            # the request priced as recorded (each epoch under its
            # design), added once to the request-major totals and per
            # site to the site-major ones
            req_e = dict.fromkeys(ACTUATED_COMPONENTS, 0.0)
            for sr in site_records:
                e = actuated_site_energy(sr, self.mcfg.primary_design)
                site_tot = self._act_sites.setdefault(
                    sr.site, dict.fromkeys(ACTUATED_COMPONENTS, 0.0))
                for c in ACTUATED_COMPONENTS:
                    req_e[c] += e[c]
                    site_tot[c] += e[c]
            for c in ACTUATED_COMPONENTS:
                self._act_totals[c] += req_e[c]
            energy[ACTUATED] = {c: req_e[c] for c in monitor.COMPONENTS}
        return RequestPowerReport(
            uid=acc.uid, prompt_tokens=acc.prompt_tokens,
            new_tokens=new_tokens, decode_steps=acc.decode_steps,
            sampled_steps=acc.sampled_steps, energy=energy,
            zero_fraction=zf_sum / max(zf_n, 1),
            sites=tuple(sorted(set(acc.prefill) | set(acc.decode))),
            reference=self.mcfg.reference_design,
            primary=self.mcfg.primary_design)

    # ----------------------------------------------------------- recording
    def record_prefill(self, slot: int, acts: torch.Tensor,
                       weight: torch.Tensor, site: str) -> None:
        """One prefill matmul of the slot's request: ``acts [..., K]`` (its
        real prompt rows only), ``weight [K, N]``."""
        acts, weight = gather_local(acts), gather_local(weight)
        A = acts.reshape(-1, acts.shape[-1])
        m = A.shape[0]
        # rows pre-sampled to a power-of-two budget, as the JAX package
        # does to bound its compiles; even-stride sampling + back-scaling
        # keeps ratios exact and totals unbiased
        ms = 1 << (min(m, self.mcfg.max_rows).bit_length() - 1)
        a2, w2 = monitor.subsample_operands(
            monitor._subsample(A, ms, 0), weight, self.mcfg)
        counters = {k: float(v) for k, v in
                    monitor.stream_counters(a2, w2, self.mcfg).items()}
        zf = counters.pop("zero_fraction")
        factor = monitor.sampled_fraction_scale(
            m, A.shape[1], weight.shape[1], self.mcfg, sampled_m=ms)
        acc = self._slots[slot]
        name = f"prefill/{site}"
        rec = acc.prefill.get(name)
        if rec is None:
            rec = acc.prefill[name] = _SiteRec(
                (1, m, A.shape[1], weight.shape[1]))
        else:
            # a re-prefill after preemption streams more rows through the
            # site: the booked MAC extent grows with the energy
            rec.shape = (1, rec.shape[1] + m, rec.shape[2], rec.shape[3])
        rec.add({k: v * factor for k, v in counters.items()}, zf,
                self.design_for(name))

    def tick(self, slots: list[int]) -> bool:
        """Advance live slots by one decode step; True when this step is
        sampled (the engine then calls :meth:`record_decode`). The cadence
        follows the GLOBAL decode-step counter; a request's first decode
        step is always sampled."""
        self._global_step += 1
        due_global = (self._global_step - 1) % self.sample_every == 0
        sample = False
        for s in slots:
            acc = self._slots[s]
            acc.decode_steps += 1
            acc.due = due_global or acc.decode_steps == 1
            sample = sample or acc.due
        return sample

    def record_decode(self, slots: list[int], acts: torch.Tensor,
                      weight: torch.Tensor, site: str) -> None:
        """One decode-step matmul across the whole batch: ``acts [B, K]``
        (a row per KV slot), ``weight [K, N]``. Only rows in ``slots``
        that are due this step are credited."""
        acts, weight = gather_local(acts), gather_local(weight)
        if self._split:
            if self._fused:
                wc, wz, nc, nz, _ = _fused_decode_counters(
                    acts, weight, self.mcfg, self.kernel_backend)
            else:
                wc, wz, nc, nz = _ref_decode_counters(acts, weight,
                                                      self.mcfg)
            per_row = _assemble_decode(
                wc, wz, nc, nz, self.mcfg,
                min(weight.shape[1], self.mcfg.max_cols))
        else:
            per_row = _rows_counters(acts, weight, self.mcfg)
        per_row = {k: v.tolist() for k, v in per_row.items()}
        factor = monitor.sampled_fraction_scale(
            1, acts.shape[1], weight.shape[1], self.mcfg)
        name = f"decode/{site}"
        for s in slots:
            acc = self._slots[s]
            if not acc.due:
                continue
            row = {k: v[s] for k, v in per_row.items()}
            zf = row.pop("zero_fraction")
            rec = acc.decode.setdefault(
                name, _SiteRec((1, 1, acts.shape[1], weight.shape[1])))
            rec.add({k: v * factor for k, v in row.items()}, zf,
                    self.design_for(name))

    def mark_sampled(self, slots: list[int]) -> None:
        """Book that this step's records covered these slots (once per
        sampled step, after the per-site record_decode calls)."""
        for s in slots:
            acc = self._slots[s]
            if acc.due:
                acc.sampled_steps += 1

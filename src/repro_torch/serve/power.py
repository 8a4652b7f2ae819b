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
from repro_torch.kernels.zvg_matmul.ref import pad_lanes
from repro_torch.trace.capture import CaptureConfig, TraceCapture


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
    nrows = pc.edge_counters(pad_lanes(to_bits(W2), lanes_n), nspec,
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
        self.zf_sum = 0.0
        self.zf_n = 0

    def add(self, counters: dict, zf: float):
        for k, v in counters.items():
            self.counters[k] = self.counters.get(k, 0.0) + v
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
        for kind, recs in (("prefill", acc.prefill), ("decode", acc.decode)):
            for site, rec in recs.items():
                counters, shape = rec.counters, rec.shape
                if kind == "decode":
                    counters = {k: v * scale for k, v in counters.items()}
                    # MACs extrapolate with the energies
                    shape = (acc.decode_steps,) + rec.shape[1:]
                for k, v in counters.items():
                    total[k] = total.get(k, 0.0) + v
                zf_sum += rec.zf_sum
                zf_n += rec.zf_n
                self.capture.record_counters(
                    site, "dot_general", shape,
                    {**counters, "zero_fraction": rec.zf_mean})
        energy = monitor.counters_to_energy(total)
        # every configured design, all-zero for a request that retired
        # with no sampled records
        for name in self.mcfg.design_names:
            comps = energy.setdefault(name, {})
            for c in monitor.COMPONENTS:
                comps.setdefault(c, 0.0)
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
        name = f"prefill/{site}"
        rec = self._slots[slot].prefill.setdefault(
            name, _SiteRec((1, m, A.shape[1], weight.shape[1])))
        rec.add({k: v * factor for k, v in counters.items()}, zf)

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
            rec.add({k: v * factor for k, v in row.items()}, zf)

    def mark_sampled(self, slots: list[int]) -> None:
        """Book that this step's records covered these slots (once per
        sampled step, after the per-site record_decode calls)."""
        for s in slots:
            acc = self._slots[s]
            if acc.due:
                acc.sampled_steps += 1

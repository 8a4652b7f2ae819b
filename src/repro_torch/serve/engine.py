"""ServeEngine: continuous-batching LM serving with power accounting.

The engine owns one shared decode batch of ``max_slots`` KV-cache slots
and pumps it with :meth:`ServeEngine.step`:

  1. **admit** -- while a slot is free and the queue is not empty, prefill
     the next request (batch 1, the prompt right-padded to a power-of-two
     bucket), copy its states into the free slot, and sample its first
     token from the prefill logits;
  2. **decode** -- one shared decode step over all ``max_slots`` rows,
     each live slot at its own position (dead rows compute garbage that
     nothing reads); every projection, MLP and lm-head matmul runs the
     ZVG-gated row matmul (K2), and per-request sampling parameters are
     ``[B]`` tensors, so greedy and stochastic requests co-batch;
  3. **retire** -- EOS, token budget or cache horizon, in slot order; the
     freed slot is open to the next step's admission.

Each row of the decode step depends only on that row's cache and
position, so a request's greedy tokens do not depend on its neighbours.

Power accounting (``power_monitor=True``): each admitted request gets a
:class:`repro_torch.serve.power.PowerAccountant` slot that accumulates
BIC + ZVG counters over its own operand streams -- its prompt rows at
admission (K1), its embedded decode inputs each sampled step (K3) --
streamed against representative layer-0 weights, and retirement attaches
a :class:`RequestPowerReport`.

``ServeConfig.kernel_backend`` selects the kernels: ``"auto"`` (the
Hopper kernels for CUDA tensors, their plain versions on the CPU),
``"cuda"``, or ``"ref"`` (the plain versions on any device). The engine
runs on ``ServeConfig.device``, the card by default.

With ``ServeConfig.paging`` set, ``ServeEngine(...)`` returns a
:class:`repro_torch.serve.paging.engine.PagedServeEngine`, which keeps
this step loop and overrides the hooks ``_build_state``,
``_admission_phase``, ``_decode_ready`` and ``_release_slot``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import monitor as pm_monitor
from repro_torch.kernels.power_counters.ops import BACKENDS
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig

from . import sampling
from .cache import SlotCache
from .power import PowerAccountant
from .request import Request, RequestStatus
from .scheduler import FIFOScheduler


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs (not architecture)."""
    max_slots: int = 4            # decode batch width = max concurrency
    cache_len: int = 128          # KV positions per slot
    eos_id: int | None = None     # retire when a request samples this token
    seed: int = 0                 # sampling generator seed
    prompt_buckets: tuple[int, ...] = ()   # explicit prefill lengths
    power_monitor: bool = False   # per-request BIC+ZVG power reports
    monitor: pm_monitor.MonitorConfig = pm_monitor.DEFAULT_MONITOR
    power_sample_every: int = 1   # stream every k-th decode step
    kernel_backend: str = "auto"  # "auto" | "cuda" | "ref" (module doc)
    device: str = "cuda"
    # the paged KV cache (a paging.PagingConfig); None = slot cache. When
    # set, max_slots gives way to paging.max_rows and cache_len is the
    # per-request position horizon, not a per-request reservation
    paging: object | None = None
    # not ported yet: telemetry (ROADMAP step 11); ServeEngine refuses it
    telemetry: object | None = None

    def __post_init__(self):
        if self.kernel_backend not in BACKENDS:
            raise ValueError(f"unknown kernel_backend "
                             f"{self.kernel_backend!r}; expected one of "
                             f"{BACKENDS}")
        if (torch.device(self.device).type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                "CUDA is not available: the serving engine runs on the "
                "card by default; pass device='cpu' to run it on the CPU")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


class ServeEngine:
    """Continuous-batching serving over one model and one slot cache.

    ``params`` are the float32 masters of
    :func:`repro_torch.models.lm.init_model` (or converted from the JAX
    package); the engine moves them to ``scfg.device``.
    """

    def __new__(cls, params=None, cfg=None, scfg=None, mesh=None):
        if cls is ServeEngine and scfg is not None and scfg.paging is not None:
            from .paging.engine import PagedServeEngine
            return super().__new__(PagedServeEngine)
        return super().__new__(cls)

    def __init__(self, params: dict, cfg: ArchConfig, scfg: ServeConfig,
                 mesh=None):
        missing = [name for name, v in (("mesh", mesh),
                                        ("telemetry", scfg.telemetry))
                   if v is not None]
        if missing:
            raise NotImplementedError(
                f"{', '.join(missing)} not ported yet: the port serves on "
                f"one device without telemetry (ROADMAP steps 11 and 13)")
        self.cfg = cfg
        self.scfg = scfg
        self.device = torch.device(scfg.device)
        self.dtype = lm.compute_dtype(cfg)
        self.params = _to(params, self.device)
        self.weights = lm.compute_weights(self.params, cfg)
        # the accountant streams bfloat16 embeddings whatever the compute
        # dtype (the JAX package's embed step)
        self._embed_bf16 = (self.weights["embed"]
                            if self.dtype == torch.bfloat16
                            else self.params["embed"].to(torch.bfloat16))
        self._build_state()        # cache + scheduler (paged overrides)
        self._prefill = lm.make_slot_prefill_step(cfg, scfg.cache_len)
        self._decode = lm.make_decode_step(cfg, scfg.kernel_backend)
        self._embed = lm.make_embed_step(cfg)
        self._running: dict[int, Request] = {}
        self._temp = np.zeros(self._batch, np.float32)
        self._topk = np.zeros(self._batch, np.int64)
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        self.accountant = (PowerAccountant(scfg.monitor,
                                           scfg.power_sample_every,
                                           kernel_backend=scfg.kernel_backend)
                           if scfg.power_monitor else None)
        self._power_weights = (lm.pick_monitor_weights(self.params, cfg)
                               if scfg.power_monitor else [])
        self.stats = {"steps": 0, "decode_steps": 0, "tokens": 0,
                      "occupancy_sum": 0, "peak_live": 0}

    def _build_state(self) -> None:
        """Cache, scheduler and decode batch width (subclass hook)."""
        self._batch = self.scfg.max_slots
        self.cache = SlotCache(self.cfg, self.scfg.max_slots,
                               self.scfg.cache_len, self.dtype, self.device)
        self.scheduler = FIFOScheduler(self.scfg.cache_len)

    # -------------------------------------------------------------- submit
    def submit(self, req: Request | list[int], **kw) -> Request:
        """Queue a request (or a bare prompt, with Request kwargs)."""
        if isinstance(req, Request):
            if kw:
                raise TypeError(
                    f"keyword arguments {sorted(kw)} are ignored when "
                    f"submitting a Request instance; set them on the "
                    f"Request itself")
        else:
            req = Request(prompt=list(req), **kw)
        req = self.scheduler.submit(req)
        req.submit_step = self.stats["steps"]
        return req

    # ---------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> list[Request]:
        """One engine iteration: admit, one shared decode, retire.
        Returns the requests retired during this step."""
        retired: list[Request] = []
        self._admission_phase(retired)
        live = self._decode_ready()
        if live:
            inputs = self.cache.decode_inputs()
            if self.accountant is not None and self.accountant.tick(live):
                x = self._embed(self._embed_bf16, inputs[0])[:, 0]
                for site, w in self._power_weights:
                    self.accountant.record_decode(live, x, w, site)
                self.accountant.mark_sampled(live)
            logits = self._decode(self.weights, self.cache.states, *inputs)
            toks = self._sample(logits, self._temp, self._topk).tolist()
            for slot in live:
                req = self._running[slot]
                self.cache.advance(slot, toks[slot])
                req.generated.append(toks[slot])
                self.stats["tokens"] += 1
                self._maybe_retire(req, retired)
            self.stats["decode_steps"] += 1
            self.stats["occupancy_sum"] += len(live)
            self.stats["peak_live"] = max(self.stats["peak_live"], len(live))
        self.stats["steps"] += 1
        return retired

    def _admission_phase(self, retired: list[Request]) -> None:
        while self.cache.n_free and self.scheduler.n_pending:
            req = self.scheduler.pop_admissible(1)[0]
            self._admit(req)
            self._maybe_retire(req, retired)   # max_new == 1 / prompt EOS

    def _decode_ready(self) -> list[int]:
        """Rows entering this step's shared decode (the paged engine first
        backs every row's next write with a page here, which may
        preempt)."""
        return self.cache.live_slots()

    def run(self, max_steps: int = 0) -> list[Request]:
        """Pump :meth:`step` until queue and slots drain (or max_steps)."""
        finished: list[Request] = []
        while self.scheduler.n_pending or self.cache.n_live:
            finished.extend(self.step())
            if max_steps and self.stats["steps"] >= max_steps:
                break
        return finished

    # ------------------------------------------------------------ internals
    def _sample(self, logits, temp: np.ndarray, topk: np.ndarray):
        dev = logits.device
        return sampling.sample_tokens(logits, torch.from_numpy(temp).to(dev),
                                      torch.from_numpy(topk).to(dev),
                                      self._gen).cpu()

    def _bucket(self, length: int) -> int:
        """Static prefill length for a prompt: the smallest explicit
        bucket that holds it, else the next power of two, at most
        ``cache_len - 1``."""
        for b in sorted(self.scfg.prompt_buckets):
            if b >= length:
                return min(b, self.scfg.cache_len - 1)
        bucket = 1
        while bucket < length:
            bucket *= 2
        return min(bucket, self.scfg.cache_len - 1)

    def _padded_tokens(self, seq: list[int]) -> torch.Tensor:
        """``seq`` right-padded with token 0 to its bucket, ``[1, S]`` on
        the engine's device."""
        bucket = max(self._bucket(len(seq)), len(seq))
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :len(seq)] = torch.tensor(seq)
        return toks.to(self.device)

    def _admit(self, req: Request) -> None:
        slot = self.cache.allocate()
        req.slot = slot
        req.status = RequestStatus.RUNNING
        req.start_step = self.stats["steps"]
        length = req.prompt_len
        toks = self._padded_tokens(req.prompt)
        logits, states1 = self._prefill(self.weights, toks, length)
        first = self._sample_first(req, logits)
        self.cache.write_prefill(slot, states1, first, length)
        req.generated.append(first)
        self.stats["tokens"] += 1
        self._running[slot] = req
        if self.accountant is not None:
            self.accountant.begin(slot, req.uid, length)
            self._record_prefill_power(slot, toks, 0, length)

    def _sample_first(self, req: Request, logits) -> int:
        """Install the request's sampling parameters on its slot and draw
        its first token from the batch-1 prefill logits."""
        slot = req.slot
        self._temp[slot] = req.sampling.temperature
        self._topk[slot] = req.sampling.top_k
        return int(self._sample(logits, self._temp[slot:slot + 1],
                                self._topk[slot:slot + 1])[0])

    def _record_prefill_power(self, slot: int, toks: torch.Tensor, lo: int,
                              length: int) -> None:
        """Stream the prompt rows ``[lo, length)`` of the padded tokens
        through the monitored sites. ``lo > 0`` is a prefix reuser, which
        pays only for the suffix it computed (the first payer keeps the
        shared pages' energy)."""
        x = self._embed(self._embed_bf16, toks)[:, lo:length]
        for site, w in self._power_weights:
            self.accountant.record_prefill(slot, x, w, site)

    def _maybe_retire(self, req: Request, retired: list[Request]) -> None:
        reason = self.scheduler.retire_reason(
            req, int(self.cache.positions[req.slot]), self.scfg.eos_id)
        if reason:
            self._retire(req, reason, retired)

    def _retire(self, req: Request, reason: str,
                retired: list[Request]) -> None:
        slot = req.slot
        if self.accountant is not None:
            req.power = self.accountant.finish(slot, len(req.generated))
        self._release_slot(slot)
        self._temp[slot] = 0.0
        self._topk[slot] = 0
        self._running.pop(slot)
        req.status = RequestStatus.FINISHED
        req.finish_reason = reason
        req.finish_step = self.stats["steps"]
        retired.append(req)

    def _release_slot(self, slot: int) -> None:
        self.cache.release(slot)

    def cancel(self, uid: int) -> bool:
        """Drop a request that has not been admitted yet (the slot cache
        never evicts running work; the paged engine cancels anywhere)."""
        return self.scheduler.cancel(uid)

    # -------------------------------------------------------------- views
    def trace_report(self):
        """Serve-wide paper-style TraceReport over every retired request
        (requires power_monitor=True)."""
        if self.accountant is None:
            raise RuntimeError("power_monitor is off")
        from repro_torch.trace.report import build_report
        return build_report(self.accountant.capture,
                            model=f"serve/{self.cfg.name}")

    def occupancy(self) -> float:
        """Mean live slots per decode step (batch efficiency)."""
        return self.stats["occupancy_sum"] / max(self.stats["decode_steps"],
                                                 1)

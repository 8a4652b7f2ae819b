"""PagedServeEngine: the serving engine over a block-paged KV cache.

``ServeEngine(params, cfg, scfg)`` returns this subclass whenever
``scfg.paging`` is set. The step loop stays the base engine's (admit, one
shared decode, retire); what changes is the capacity model under it:

* **admission** allocates pages for the prompt actually given (plus any
  tokens a resumed request already generated), not a ``cache_len`` slot,
  so many short requests run where the slot engine holds ``max_slots``;
* **chunked prefill** streams a prompt longer than ``prefill_chunk``
  through admission one chunk per engine step, each chunk writing its
  K/V into the row's pages and attending to the paged history, so a long
  prompt does not stall the decode batch;
* **shared prefixes** (``prefix_cache=True``) are matched page by page in
  a refcounted trie: a hit puts read-only pages at the front of the row's
  table and prefill starts at the first unshared position;
* **page pressure preempts**: with no free page and no evictable prefix
  page, the lowest-priority, latest-admitted request is evicted -- its
  pages go back, its accounting is suspended, and it is re-queued at the
  front of its class to prefill its prompt and generated tokens again.

Power accounting stays exact under all of it:

* the prompt is streamed through ``record_prefill`` once at admission,
  however prefill is chunked (the BIC/ZVG counters are statistics of one
  contiguous stream);
* a prefix reuser records only the suffix it computes: the first payer
  keeps the energy of the shared pages;
* preemption suspends the accumulator, and the re-prefill records more
  rows -- recomputation is energy spent;
* reports reach the serve-wide capture only at retirement, so retired
  energies still sum to ``trace_report()``.

The decode step's attention is the paged decode attention (K4 on the
card) for ``attn``; chunks run the gather and the plain chunk attention,
as prefill runs plain code. MLA archs page their latent caches
(``ckv``/``kr``) and gather them in decode and chunks alike, as the JAX
package does: no K4 there.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.models import lm
from repro_torch.runtime import spans
from repro_torch.models.transformer import parse_spec

from ..engine import ServeEngine
from ..request import Request, RequestStatus
from .cache import PagedKVCache
from .prefix import PrefixCache
from .scheduler import ClassScheduler


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class _ChunkJob:
    """Progress of one streaming prefill (one per reserved row): ``seq``
    is the whole sequence being prefilled (the prompt, or on resume the
    prompt and the tokens generated so far), ``next`` the first position
    the next chunk computes."""
    seq: list[int]
    next: int


class PagedServeEngine(ServeEngine):
    """ServeEngine over a page pool; see the module docstring."""

    def __init__(self, params, cfg, scfg, mesh=None):
        super().__init__(params, cfg, scfg, mesh)
        self._chunk = self._mesh_step(lm.make_chunk_prefill_step(
            cfg, expert_backend=self._compute_backend))
        pcfg = scfg.paging
        self.prefix = (PrefixCache(pcfg.page_size)
                       if pcfg.prefix_cache else None)
        self._jobs: dict[int, _ChunkJob] = {}      # row -> chunk prefill
        self._suspended: dict[int, object] = {}    # uid -> accumulator
        self.stats.update(preemptions=0, chunk_calls=0,
                          prefix_hit_requests=0, peak_admitted=0)

    def _build_state(self) -> None:
        pcfg = self.scfg.paging
        mixers = {parse_spec(s)[0] for s in self.cfg.block_specs}
        if not mixers <= {"attn", "mla"}:
            raise ValueError(
                f"paged serving supports position-masked cache mixers "
                f"(attn/mla) only; {self.cfg.name} uses "
                f"{sorted(mixers - {'attn', 'mla'})}")
        if self.cfg.pos == "mrope":
            raise ValueError("paged serving does not support mrope")
        self._batch = pcfg.max_rows
        self.cache = PagedKVCache(self.cfg, pcfg.max_rows,
                                  self.scfg.cache_len, pcfg.page_size,
                                  pcfg.num_pages, self.dtype, self.device,
                                  mesh=self.mesh)
        self.scheduler = ClassScheduler(
            self.scfg.cache_len, pcfg.classes, page_size=pcfg.page_size,
            usable_pages=pcfg.num_pages - 1)

    # ----------------------------------------------------------- admission
    def _admission_phase(self, retired: list[Request]) -> None:
        for row in sorted(self._jobs):
            self._pump_chunk(row, retired)
        while self.cache.n_free and self.scheduler.n_pending:
            req = self.scheduler.pop_admissible(1)[0]
            if not self._try_admit(req, retired):
                # the head of its class waits for pages, keeping its place
                self.scheduler.requeue_front(req)
                break
        self.stats["peak_admitted"] = max(self.stats["peak_admitted"],
                                          self.cache.n_live)

    def _try_admit(self, req: Request, retired: list[Request]) -> bool:
        t_admit = time.perf_counter_ns()
        pcfg = self.scfg.paging
        ps = pcfg.page_size
        resume = bool(req.generated)
        # a resumed request embeds all but its pending token, which stays
        # the decode input it was when it was preempted
        seq = (req.prompt + req.generated[:-1]) if resume else req.prompt
        length = len(seq)
        # an attempt that finds no pages ends here: serve.pages counts
        # attempts, serve.admit admissions
        with spans.span("serve.pages"):
            shared: list[int] = []
            if self.prefix is not None:
                # keep >= 1 unshared token, whose logits give the first
                # token
                shared = self.prefix.match(seq, (length - 1) // ps)
            start = len(shared) * ps
            owned = self._acquire_pages(_ceil_div(length, ps) - len(shared),
                                        req, admission=True)
            if owned is None:
                if shared:
                    self.prefix.release(shared)
                return False
        req.t_admit = req.t_admit or t_admit
        with spans.span("serve.admit"):
            self.stats["admissions"] += 1
            self.stats["prefill_rows"] += length - start
            self.stats["prefix_hit_rows"] += start
            row = self.cache.allocate()
            req.slot = row
            req.status = RequestStatus.RUNNING
            req.start_step = self.stats["steps"]
            self.cache.set_table(row, shared + owned, len(shared))
            self._running[row] = req
            if shared:
                self.stats["prefix_hit_requests"] += 1
            toks = self._padded_tokens(seq)
            if self.accountant is not None:
                acc = self._suspended.pop(req.uid, None)
                if acc is not None:
                    self.accountant.resume(row, acc)
                else:
                    self.accountant.begin(row, req.uid, req.prompt_len)
                # the whole computed extent in one call, however prefill
                # is chunked: the counters are statistics of one
                # contiguous stream
                self._record_prefill_power(row, toks, start, length)
            if start == 0 and (pcfg.prefill_chunk == 0
                               or length <= pcfg.prefill_chunk):
                # the slot engine's dense prefill, then its states copied
                # into this row's pages
                with spans.span("serve.prefill"):
                    logits, states1 = self._prefill(self.weights, toks,
                                                    length)
                self.cache.scatter_prefill(row, states1,
                                           _ceil_div(length, ps))
                self._finish_prefill(row, logits, retired)
            else:
                self._jobs[row] = _ChunkJob(seq, start)
                self._pump_chunk(row, retired)
        return True

    def _pump_chunk(self, row: int, retired: list[Request]) -> None:
        """Run one prefill chunk of a reserved row; the chunk that holds
        the sequence's last position activates the row."""
        job = self._jobs[row]
        length = len(job.seq)
        width = (self.scfg.paging.prefill_chunk
                 or _pow2_at_least(length - job.next))
        start, end = job.next, min(job.next + width, length)
        toks = torch.zeros((1, width), dtype=torch.int64)
        poss = torch.full((1, width), -1, dtype=torch.int64)  # pads -> trash
        toks[0, :end - start] = torch.tensor(job.seq[start:end])
        poss[0, :end - start] = torch.arange(start, end)
        with spans.span("serve.chunk_prefill"):
            logits = self._chunk(self.weights, self.cache.states,
                                 toks.to(self.device), poss.to(self.device),
                                 torch.from_numpy(
                                     self.cache.tables[row:row + 1])
                                 .to(self.device),
                                 length, start)
        self.stats["chunk_calls"] += 1
        job.next = end
        if end >= length:
            self._jobs.pop(row)
            self._finish_prefill(row, logits, retired)

    def _finish_prefill(self, row: int, logits,
                        retired: list[Request]) -> None:
        req = self._running[row]
        if req.generated:                          # resumed after preemption
            self._temp[row] = req.sampling.temperature
            self._topk[row] = req.sampling.top_k
            self.cache.activate(row, req.generated[-1],
                                req.prompt_len + len(req.generated) - 1)
        else:
            first = self._sample_first(req, logits)
            self.cache.activate(row, first, req.prompt_len)
            req.generated.append(first)
            self.stats["tokens"] += 1
            if self.prefix is not None:
                self._insert_prefix(req, row)
            req.t_first = time.perf_counter_ns()
        self._maybe_retire(req, retired)

    def _insert_prefix(self, req: Request, row: int) -> None:
        """Register the request's written full prompt pages for reuse: the
        prefix cache takes them over, and the row goes on reading them as
        leading shared table entries."""
        n_full = req.prompt_len // self.scfg.paging.page_size
        n_held = int(self.cache.n_shared[row])
        if n_full <= n_held:
            return
        tbl = self.cache.tables[row]
        absorbed = self.prefix.insert(
            req.prompt, [int(p) for p in tbl[:n_held]],
            [int(p) for p in tbl[n_held:n_full]])
        self.cache.n_shared[row] = n_held + absorbed

    # ------------------------------------------------------ page pressure
    def _prio(self, req: Request) -> int:
        return self.scheduler.classes[req.klass].priority

    def _acquire_pages(self, n: int, req: Request,
                       admission: bool) -> list[int] | None:
        """``n`` pages for ``req``: from the free list, else by evicting an
        unread prefix page (LRU), else by preempting a victim. Admission
        preempts only strictly lower priority (an arrival never displaces
        its equals); decode may take an equal-priority, later-started
        victim, since the requester cannot go on otherwise. None: the
        caller must yield."""
        while True:
            if self.cache.n_free_pages >= n:
                return self.cache.allocate_pages(n)
            if self.prefix is not None:
                page = self.prefix.pop_evictable()
                if page != -1:
                    self.cache.free_pages([page])
                    continue
            victim = self._pick_victim(req, admission)
            if victim is None:
                return None
            self._preempt(victim)

    def _pick_victim(self, req: Request, admission: bool) -> int | None:
        rp = self._prio(req)
        cands = []
        for row, cand in self._running.items():
            if cand is req:
                continue
            p = self._prio(cand)
            if p > rp or (admission and p >= rp):
                continue
            cands.append((p, -cand.start_step, row))
        return min(cands)[2] if cands else None

    def _preempt(self, row: int) -> None:
        """Evict a running (or mid-prefill) row: its pages go back, its
        accounting is suspended, it re-queues at the front of its class."""
        req = self._running.pop(row)
        self._jobs.pop(row, None)
        if self.accountant is not None:
            self._suspended[req.uid] = self.accountant.suspend(row)
        self._release_slot(row)
        self._temp[row] = 0.0
        self._topk[row] = 0
        req.slot = -1
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.scheduler.requeue_front(req)

    def _decode_ready(self) -> list[int]:
        """Back every live row's next write position with a page before
        the shared decode; the highest-priority, earliest-admitted rows
        go first, so pressure lands on the rows preemption would pick."""
        with spans.span("serve.pages"):
            rows = sorted(self.cache.live_slots(),
                          key=lambda r: (-self._prio(self._running[r]),
                                         self._running[r].start_step))
            for row in rows:
                if not self.cache.live[row]:   # preempted by an earlier row
                    continue
                if not self.cache.next_write_unbacked(row):
                    continue
                got = self._acquire_pages(1, self._running[row],
                                          admission=False)
                if got is None:
                    self._preempt(row)         # yields: the sole candidate
                else:
                    self.cache.grow_table(row, got[0])
            return self.cache.live_slots()

    # ----------------------------------------------------------- lifecycle
    def _release_slot(self, slot: int) -> None:
        owned, shared = self.cache.release(slot)
        if owned:
            self.cache.free_pages(owned)
        if shared:
            self.prefix.release(shared)

    def cancel(self, uid: int) -> bool:
        """Cancel anywhere in the lifecycle: a queued request is dropped; a
        running or mid-prefill one retires as "cancelled", its owned pages
        freed and shared ones released; one cancelled while preempted
        books its suspended (already spent) energy, so retired energies
        still sum to the trace."""
        for row, req in list(self._running.items()):
            if req.uid == uid:
                self._jobs.pop(row, None)
                self._retire(req, "cancelled", [])
                return True
        req = self.scheduler.find(uid)
        if req is None:
            return False
        self.scheduler.cancel(uid)
        acc = self._suspended.pop(uid, None)
        if acc is not None and self.accountant is not None:
            req.power = self.accountant.finish_detached(acc,
                                                        len(req.generated))
        return True

"""Property/fuzz tests of the port's schedulers, slot and page pools and
paged engine under random churn (``repro_torch.serve``), the port of
``tests/test_serve_scheduler_fuzz.py`` with the same properties and
``max_examples``, through the hypothesis shim:

  * strict FIFO: requests are admitted in submission order, no matter
    how admission windows and cancellations interleave;
  * admission never over-commits: every admitted request's worst-case
    footprint (prompt + max_new_tokens) fits ``cache_len``, and
    infeasible requests are rejected at submit (never queued);
  * the "cache" retirement reason is unreachable when admission
    validated the footprint;
  * freed slots are immediately reusable, always lowest-index-first,
    and the pool never leaks (n_free + n_live == max_slots throughout);
  * ClassScheduler is strictly prioritized across classes, FIFO within
    a class, and deficit-round-robin fair among equal-priority
    backlogs; ``requeue_front`` re-admits a preempted request before
    any later arrival of its class;
  * the page pool never over-commits and never leaks;
  * preemption + resume is invisible in the token stream;
  * cancelling requests -- queued, running, or mid-chunk -- returns
    every page to the pool and every prefix pin.

Host-side properties run with no model; the engine-level ones run the
port's smoke Qwen1.5-0.5B (float32, weights from seed 0) on the CPU.
"""
import numpy as np
import pytest

import torch

from _hypothesis_compat import given, settings, st
from repro_torch.configs import SMOKES
from repro_torch.models import lm
from repro_torch.serve import (TRASH, ClassScheduler, FIFOScheduler,
                               PagedKVCache, PagingConfig, Request,
                               SchedClass, ServeConfig, ServeEngine,
                               SlotCache)

_CFG = SMOKES["qwen1.5-0.5b"].with_(compute_dtype="float32")


# ------------------------------------------------------------ scheduler
@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 40),     # prompt_len
                          st.integers(1, 40)),    # max_new_tokens
                min_size=1, max_size=24),
       st.integers(0, 2 ** 16))
def test_fifo_churn_preserves_order_and_never_overcommits(reqs, seed):
    cache_len = 32
    sched = FIFOScheduler(cache_len)
    rng = np.random.default_rng(seed)
    submitted = []
    for plen, mnew in reqs:
        req = Request(prompt=list(range(plen)), max_new_tokens=mnew)
        if plen + mnew > cache_len:
            with pytest.raises(ValueError, match="cache"):
                sched.submit(req)
            assert req.uid == -1              # rejected: never queued
            continue
        submitted.append(sched.submit(req).uid)
    assert sched.n_pending == len(submitted)

    admitted = []
    while sched.n_pending:
        # random admission window, like a fluctuating free-slot count
        got = sched.pop_admissible(int(rng.integers(0, 4)))
        admitted.extend(r.uid for r in got)
        for r in got:                         # footprint was validated
            assert r.prompt_len + r.max_new_tokens <= cache_len
    assert admitted == submitted              # strict FIFO, no losses


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.integers(1, 20),     # prompt_len
                          st.integers(1, 12),     # max_new_tokens
                          st.integers(0, 30)),    # eos offset (may miss)
                min_size=1, max_size=16))
def test_cache_retirement_reason_is_unreachable(reqs):
    """Simulate every admitted request's full decode: position starts at
    prompt_len and advances once per generated token. Validated
    admission means "eos"/"length" always fires before the position can
    reach cache_len."""
    cache_len = 32
    eos_id = 7
    sched = FIFOScheduler(cache_len)
    for plen, mnew, eos_at in reqs:
        req = sched.submit(Request(prompt=list(range(plen)),
                                   max_new_tokens=mnew))
        position = req.prompt_len
        reason = ""
        while not reason:
            # the engine samples a token, writes it at `position`, then
            # checks retirement; eos_at decides if/when EOS is drawn
            tok = eos_id if len(req.generated) == eos_at else eos_id + 1
            req.generated.append(tok)
            position += 1
            assert position <= cache_len, "over-committed cache"
            reason = sched.retire_reason(req, position, eos_id)
        assert reason in ("eos", "length"), reason
        assert len(req.generated) <= req.max_new_tokens


@settings(max_examples=30, deadline=None)
@given(st.lists(st.integers(1, 8), min_size=1, max_size=12),
       st.lists(st.integers(0, 11), max_size=6))
def test_cancel_drops_only_queued_and_keeps_fifo(budgets, cancels):
    sched = FIFOScheduler(64)
    reqs = [sched.submit(Request(prompt=[1, 2], max_new_tokens=b))
            for b in budgets]
    cancelled = set()
    for idx in cancels:
        if idx < len(reqs) and reqs[idx].uid not in cancelled:
            assert sched.cancel(reqs[idx].uid)
            assert reqs[idx].finish_reason == "cancelled"
            cancelled.add(reqs[idx].uid)
        else:
            assert not sched.cancel(10_000 + idx)   # unknown uid
    survivors = [r.uid for r in reqs if r.uid not in cancelled]
    out = [r.uid for r in sched.pop_admissible(len(reqs))]
    assert out == survivors                   # FIFO among survivors
    for uid in cancelled:
        assert not sched.cancel(uid)          # already gone


# ------------------------------------------------------------ slot pool
@settings(max_examples=20, deadline=None)
@given(st.lists(st.booleans(), min_size=1, max_size=60),
       st.integers(1, 5))
def test_slot_pool_reuse_under_random_churn(ops, max_slots):
    """Random allocate/release churn: the pool never leaks, always hands
    out the lowest free slot, and freed slots are reusable immediately."""
    cache = SlotCache(_CFG, max_slots, 8, torch.float32, "cpu")
    live = []
    rng = np.random.default_rng(len(ops))
    for want_alloc in ops:
        assert cache.n_free + cache.n_live == max_slots
        if want_alloc:
            if cache.n_free == 0:             # full pool refuses
                with pytest.raises(RuntimeError):
                    cache.allocate()
                continue
            free_before = {s for s in range(max_slots)
                           if s not in live}
            slot = cache.allocate()
            assert slot == min(free_before)   # lowest-first, determinism
            assert slot not in live
            live.append(slot)
        elif live:
            slot = live.pop(int(rng.integers(0, len(live))))
            cache.release(slot)
            assert not cache.live[slot]
            assert cache.positions[slot] == 0
    assert cache.n_live == len(live)
    assert sorted(cache.live_slots()) == sorted(live)
    # double release always refuses
    if live:
        cache.release(live[0])
        with pytest.raises(RuntimeError):
            cache.release(live[0])


# ----------------------------------------------------- class scheduler
@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 2),       # priority
                          st.integers(1, 4),       # weight
                          st.integers(2, 8)),      # queued requests
                min_size=2, max_size=4),
       st.integers(0, 2 ** 16))
def test_class_scheduler_priority_and_drr_fairness(classes, seed):
    """Strict priority across classes, FIFO within a class, and DRR
    shares proportional to weights among an equal-priority backlog."""
    scheds = [SchedClass(f"c{i}", priority=p, weight=w)
              for i, (p, w, _) in enumerate(classes)]
    sched = ClassScheduler(64, tuple(scheds))
    rng = np.random.default_rng(seed)
    remaining = {c.name: n for c, (_, _, n) in zip(scheds, classes)}
    order = [c.name for c, (_, _, n) in zip(scheds, classes)
             for _ in range(n)]
    rng.shuffle(order)
    by_class = {c.name: [] for c in scheds}
    for name in order:
        by_class[name].append(
            sched.submit(Request(prompt=[1], max_new_tokens=1,
                                 klass=name)).uid)

    prio = {c.name: c.priority for c in scheds}
    weight = {c.name: c.weight for c in scheds}
    pops = []
    while sched.n_pending:
        top = max(prio[n] for n, k in remaining.items() if k)
        (req,) = sched.pop_admissible(1)
        # strict priority: never admits below the best backlogged tier
        assert prio[req.klass] == top, (req.klass, remaining)
        # FIFO within the class
        assert req.uid == by_class[req.klass].pop(0)
        remaining[req.klass] -= 1
        pops.append(req.klass)

    # DRR fairness over the window where the WHOLE top tier (classes at
    # the globally highest priority) stayed backlogged: normalized
    # shares (count / weight) differ by at most one full DRR round
    top_p = max(prio.values())
    tier = [n for n in prio if prio[n] == top_p]
    window = min(sum(1 for n in pops if n == t) for t in tier)
    counts = {t: 0 for t in tier}
    seen = 0
    for name in pops:
        if name in tier:
            counts[name] += 1
            seen += 1
            if counts[name] == window and seen >= len(tier):
                break
    if window >= 2:
        shares = [counts[t] / weight[t] for t in tier]
        assert max(shares) - min(shares) <= 2.0, (counts, weight)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2 ** 16))
def test_requeue_front_outranks_class_arrivals(seed):
    """A preempted request re-queued at the front is the next admission
    of ITS class, ahead of every earlier-queued classmate."""
    rng = np.random.default_rng(seed)
    sched = ClassScheduler(64, (SchedClass("a", weight=2),
                                SchedClass("b")))
    reqs = [sched.submit(Request(prompt=[1], max_new_tokens=1,
                                 klass=rng.choice(["a", "b"])))
            for _ in range(8)]
    (victim,) = sched.pop_admissible(1)
    sched.requeue_front(victim)
    readmitted = None
    while sched.n_pending:
        (req,) = sched.pop_admissible(1)
        if req.klass == victim.klass:
            readmitted = req
            break
    assert readmitted is not None and readmitted.uid == victim.uid


# -------------------------------------------------------- page pool
@settings(max_examples=15, deadline=None)
@given(st.lists(st.tuples(st.booleans(),           # alloc vs release
                          st.integers(1, 3)),      # pages wanted
                min_size=1, max_size=50),
       st.integers(5, 12),                         # num_pages
       st.integers(1, 4))                          # max_rows
def test_page_pool_never_overcommits_or_leaks(ops, num_pages, max_rows):
    """Random row/page churn: the allocatable pool is a closed count,
    allocation is all-or-nothing, the trash page is never handed out,
    and double frees are refused."""
    cache = PagedKVCache(_CFG, max_rows, 16, 4, num_pages, torch.float32,
                         "cpu")
    owned: dict[int, list[int]] = {}
    rng = np.random.default_rng(num_pages * 31 + max_rows)
    for want_alloc, k in ops:
        in_flight = sum(len(v) for v in owned.values())
        assert cache.n_free_pages + in_flight == num_pages - 1
        if want_alloc and cache.n_free:
            k = min(k, 16 // 4)                    # table capacity
            if cache.n_free_pages < k:
                with pytest.raises(RuntimeError, match="pages"):
                    cache.allocate_pages(k)
                continue
            row = cache.allocate()
            pages = cache.allocate_pages(k)
            assert TRASH not in pages
            assert len(set(pages)) == k
            cache.set_table(row, pages, 0)
            owned[row] = pages
        elif owned:
            row = int(rng.choice(list(owned)))
            got, shared = cache.release(row)
            assert got == owned.pop(row) and not shared
            cache.free_pages(got)
            with pytest.raises(RuntimeError, match="free"):
                cache.free_pages([got[0]])
    assert cache.n_free_pages + sum(len(v) for v in owned.values()) \
        == num_pages - 1


# ------------------------------------------- engine-level (real model)
_MODEL = None


def _model():
    global _MODEL
    if _MODEL is None:
        _MODEL = lm.init_model(_CFG, torch.Generator().manual_seed(0))
    return _MODEL


def _paged_engine(pages, rows=3, classes=(), chunk=0, prefix=False):
    return ServeEngine(_model(), _CFG, ServeConfig(
        cache_len=48, device="cpu", paging=PagingConfig(
            page_size=8, num_pages=pages, max_rows=rows,
            prefill_chunk=chunk, prefix_cache=prefix,
            classes=classes)))


@settings(max_examples=3, deadline=None)
@given(st.integers(7, 9),                          # tight pool size
       st.integers(0, 2 ** 16))
def test_preemption_then_resume_token_equivalence(pages, seed):
    """Fuzzed page pressure: runs that preempt and resume produce
    exactly the tokens of an uncontended ample-pool run."""
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(0, 256, int(rng.integers(10, 15)))))
               for _ in range(3)]
    mn = [int(rng.integers(4, 9)) for _ in prompts]

    def run(n_pages):
        eng = _paged_engine(n_pages)
        for p, m in zip(prompts, mn):
            eng.submit(p, max_new_tokens=m)
        out = {r.uid: r.generated for r in eng.run()}
        assert eng.cache.n_free_pages == n_pages - 1
        return out, eng.stats["preemptions"]

    ample, p0 = run(24)
    tight, _ = run(pages)
    assert p0 == 0
    assert tight == ample


@settings(max_examples=3, deadline=None)
@given(st.integers(0, 2 ** 16))
def test_cancel_frees_all_pages_under_churn(seed):
    """Cancel queued + running requests at random points; the pool must
    drain back to every allocatable page free."""
    rng = np.random.default_rng(seed)
    eng = _paged_engine(16, rows=2)
    prompts = [list(map(int, rng.integers(0, 256, int(rng.integers(4, 20)))))
               for _ in range(5)]
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    cancel = rng.choice(len(reqs), size=2, replace=False)
    eng.step()
    for i in cancel:
        eng.cancel(reqs[i].uid)
    eng.run()
    assert eng.cache.n_live == 0 and eng.cache.n_free == 2
    assert eng.cache.n_free_pages == 16 - 1
    for i in cancel:
        assert reqs[i].done


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2 ** 16))
def test_cancel_churn_chunked_prefill_prefix_conservation(seed):
    """Cancel-during-chunked-prefill churn: chunked prefill + hash-consed
    prefix sharing + a tight pool (preemption pressure), with requests
    cancelled at random steps -- including mid-chunk and while holding
    shared-prefix pins. Afterwards the page pool must conserve exactly
    (free + prefix-cached == allocatable) and every trie node's refcount
    must be back to zero: a cancelled mid-chunk request freed its
    page-table pages AND decref'd the prefix pages it pinned at
    admission."""
    rng = np.random.default_rng(seed)
    eng = _paged_engine(13, rows=3, chunk=8, prefix=True)
    base = list(map(int, rng.integers(0, 256, 16)))   # shared 2-page stem
    reqs = []
    for _ in range(6):
        tail = list(map(int, rng.integers(0, 256, int(rng.integers(4, 18)))))
        reqs.append(eng.submit(base + tail, max_new_tokens=5))
    alive = list(reqs)
    while eng.scheduler.n_pending or eng.cache.n_live:
        eng.step()
        if alive and rng.random() < 0.5:
            victim = alive.pop(int(rng.integers(0, len(alive))))
            eng.cancel(victim.uid)
    eng.run()
    assert eng.cache.n_live == 0
    assert eng.cache.n_free_pages + len(eng.prefix) == 13 - 1
    assert all(n.refs == 0 for n in eng.prefix._by_page.values())
    for r in reqs:
        assert r.done


def test_cancel_mid_chunk_releases_prefix_pins():
    """Directed regression for the cancel-during-chunked-prefill path: a
    first request pays for and inserts a shared prefix; a second request
    matches it (pinning the trie chain) and is cancelled while its
    chunked prefill is still in flight. The cancel must drop the trie
    refcounts to zero and return every non-shared page, leaving the pool
    at free + cached == allocatable with the prefix still reusable."""
    eng = _paged_engine(16, rows=2, chunk=8, prefix=True)
    base = list(range(100, 116))                      # 2 full pages
    first = eng.submit(base + [1, 2, 3], max_new_tokens=3)
    eng.run()
    assert first.done and len(eng.prefix) == 2
    pool_after_first = eng.cache.n_free_pages

    second = eng.submit(base + list(range(30, 54)), max_new_tokens=4)
    eng.step()                                        # admit: chunk 1 only
    assert second.status.name == "RUNNING"
    assert any(n.refs > 0 for n in eng.prefix._by_page.values()), \
        "second request should be pinning the shared prefix mid-chunk"
    assert eng.cancel(second.uid)
    assert second.done and second.finish_reason == "cancelled"
    assert all(n.refs == 0 for n in eng.prefix._by_page.values())
    assert eng.cache.n_free_pages == pool_after_first
    assert eng.cache.n_free_pages + len(eng.prefix) == 16 - 1
    eng.run()

"""The port's paged serving engine (``repro_torch.serve.paging``) against
the live JAX ``PagedServeEngine`` at smoke size (float32 compute, pages of
8, cache 48, power accounting on), on the same weights and prompts, and
on its own, as ``tests/test_serve_paging.py`` pins the JAX engine.

Against JAX, for ample pages, chunked prefill, shared prefixes (first
payer), preemption, priority classes and cancel (of a running and of a
preempted request): greedy tokens, each request's row, start and finish
step and preemptions, and the engine's counters are equal, per-request
energies within rtol 1e-6. The JAX engine runs its Pallas kernels in
interpret mode for the ample case (``kernel_backend="pallas"``) and its
plain path elsewhere (the two are bitwise equal on the CPU, its own
contract). The model's paged steps are held at the logits: float32
within 2e-6 of the step's largest |logit| (the frameworks' CPU dots
round apart in the last bits), the pools within 2e-6 of their largest
magnitude.

On the port alone: paged equals slot (tokens, energies and the trace,
greedy and sampled rows), churn returns every page, infeasible footprints
are refused at submit, admitted concurrency beats the slot engine at
equal memory, chunked prefill gives the dense tokens, rows mid-prefill
stay out of the decode step, and ``ClassScheduler`` admits in the JAX
scheduler's order under seeded submits, requeues and cancels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.serve import PagingConfig as JPagingConfig
from repro.serve import Request as JRequest
from repro.serve import SchedClass as JSchedClass
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve.paging import ClassScheduler as JClassScheduler
from repro_torch.configs import SMOKES
from repro_torch.models import convert, lm
from repro_torch.serve import (TRASH, ClassScheduler, PagedServeEngine,
                               PagingConfig, Request, SamplingParams,
                               SchedClass, ServeConfig, ServeEngine)

ARCH = "qwen1.5-0.5b"
CACHE_LEN = 48
PS = 8
LOGIT_TOL = 2e-6


def _prompts(n, seed, lo=2, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


_MODELS: dict = {}


def _model(arch):
    """``(jax cfg, jax params, cfg, params)`` at smoke size, float32, on
    the JAX package's weights; built once per arch."""
    if arch not in _MODELS:
        jcfg = JSMOKES[arch].with_(compute_dtype="float32")
        cfg = SMOKES[arch].with_(compute_dtype="float32")
        jparams = jlm.init_model(jax.random.key(0), jcfg)
        tree = jax.tree.map(lambda p: np.asarray(p.value), jparams,
                            is_leaf=is_param)
        _MODELS[arch] = jcfg, jparams, cfg, convert.params_from_jax(tree,
                                                                    cfg)
    return _MODELS[arch]


@pytest.fixture(scope="module")
def model():
    return _model(ARCH)


def _paged_cfg(rows=3, pages=64, chunk=0, prefix=False, classes=(),
               jax_side=False):
    pc, sc = ((JPagingConfig, JSchedClass) if jax_side
              else (PagingConfig, SchedClass))
    return pc(page_size=PS, num_pages=pages, max_rows=rows,
              prefill_chunk=chunk, prefix_cache=prefix,
              classes=tuple(sc(*c) for c in classes))


def _port(model, paging=None, **kw):
    _, _, cfg, params = model
    kw.setdefault("cache_len", CACHE_LEN)
    return ServeEngine(params, cfg, ServeConfig(device="cpu", paging=paging,
                                                **kw))


def _drain(engine, prompts, max_new=4, sampling=None):
    for i, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=max_new,
                      **({"sampling": sampling[i]} if sampling else {}))
    return {r.uid: r for r in engine.run()}


# ------------------------------------------------------ scenarios vs JAX
def _simple(prompts, max_new=4):
    def run(eng, req_cls):
        for p in prompts:
            eng.submit(req_cls(prompt=p, max_new_tokens=max_new))
        return {r.uid: r for r in eng.run()}
    return run


def _priority(eng, req_cls):
    """Two "lo" requests fill the pool; a "hi" arrival preempts one."""
    prompts = _prompts(3, seed=21, lo=10, hi=11)
    for p in prompts[:2]:
        eng.submit(req_cls(prompt=p, max_new_tokens=4, klass="lo"))
    done = {}
    for _ in range(2):
        done.update({r.uid: r for r in eng.step()})
    eng.submit(req_cls(prompt=prompts[2], max_new_tokens=4, klass="hi"))
    done.update({r.uid: r for r in eng.run()})
    return done


def _cancel(eng, req_cls):
    """Cancel a running request, then one preempted and waiting."""
    reqs = [eng.submit(req_cls(prompt=p, max_new_tokens=8))
            for p in _prompts(4, seed=22, lo=12, hi=13)]
    done = {}
    done.update({r.uid: r for r in eng.step()})
    assert eng.cancel(reqs[0].uid)                     # running
    for _ in range(40):
        if any(r.preemptions and r.status.value == "queued" for r in reqs):
            break
        done.update({r.uid: r for r in eng.step()})
    victim = next(r for r in reqs
                  if r.preemptions and r.status.value == "queued")
    assert eng.cancel(victim.uid)                      # preempted
    assert not eng.cancel(999)
    done.update({r.uid: r for r in eng.run()})
    for r in reqs:
        done.setdefault(r.uid, r)
    return done


_SHARED = _prompts(1, seed=23, lo=16, hi=17)[0]          # two full pages
CASES = {
    "ample": (dict(), _simple(_prompts(6, seed=11)), "pallas"),
    "chunked": (dict(chunk=8), _simple(_prompts(4, seed=12, lo=18, hi=40)),
                "ref"),
    "prefix": (dict(rows=4, prefix=True),
               _simple([_SHARED + t for t in _prompts(4, seed=13, lo=4,
                                                      hi=9)]), "ref"),
    "preemption": (dict(pages=7),
                   _simple(_prompts(3, seed=14, lo=12, hi=13), max_new=8),
                   "ref"),
    "priority": (dict(pages=5, classes=(("lo", 0), ("hi", 5))), _priority,
                 "ref"),
    "cancel": (dict(pages=7), _cancel, "ref"),
}
#: paged MLA (the latent caches ckv/kr in pages, gathered for the
#: absorbed decode): 5 prompts through 3 rows with ample pages, and
#: chunked prefill with one row -- with several rows the JAX engine's
#: chunked runs part from its own slot runs (ROADMAP fault 5), so those
#: are held against the port's own runs in
#: test_chunked_mla_under_concurrency
MLA_ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b")
for _arch in MLA_ARCHS:
    # the JAX engine's Pallas kernels in interpret mode on one arch, its
    # plain path on the other (bitwise equal on the CPU, its contract)
    CASES[f"{_arch} ample"] = (
        dict(), _simple(_prompts(5, seed=11)),
        "pallas" if _arch == "minicpm3-4b" else "ref", _arch)
    CASES[f"{_arch} chunked"] = (
        dict(rows=1, chunk=8), _simple(_prompts(3, seed=12, lo=18, hi=40)),
        "ref", _arch)
    CASES[f"{_arch} prefix"] = (
        dict(rows=3, prefix=True),
        _simple([_SHARED + t for t in _prompts(4, seed=13, lo=4, hi=9)]),
        "ref", _arch)


@pytest.fixture(scope="module", params=list(CASES))
def against_jax(request):
    paging, scenario, jbackend, *arch = CASES[request.param]
    model = _model(arch[0] if arch else ARCH)
    jcfg, jparams, cfg, params = model
    jeng = JServeEngine(jparams, jcfg, JServeConfig(
        cache_len=CACHE_LEN, power_monitor=True, kernel_backend=jbackend,
        paging=_paged_cfg(**paging, jax_side=True)))
    eng = _port(model, _paged_cfg(**paging), power_monitor=True)
    return (request.param, scenario(jeng, JRequest), jeng,
            scenario(eng, Request), eng)


def test_paged_engine_matches_jax(against_jax):
    case, jdone, jeng, done, eng = against_jax
    assert isinstance(eng, PagedServeEngine)
    assert done.keys() == jdone.keys()
    for uid, jr in jdone.items():
        r = done[uid]
        assert r.generated == jr.generated, uid
        assert ((r.finish_reason, r.start_step, r.finish_step,
                 r.preemptions) == (jr.finish_reason, jr.start_step,
                                    jr.finish_step, jr.preemptions)), uid
        assert (r.power is None) == (jr.power is None), uid
        if jr.power is None:
            continue
        for d, comps in jr.power.energy.items():
            for c, v in comps.items():
                np.testing.assert_allclose(r.power.energy[d][c], v,
                                           rtol=1e-6,
                                           err_msg=f"{uid} {d}/{c}")
    # the JAX engine's counters, and the port's own: each admission's
    # rows computed or taken from the prefix cache
    assert {k: eng.stats[k] for k in jeng.stats} == jeng.stats
    if not eng.stats["preemptions"]:
        admitted = [r for r in done.values() if r.start_step >= 0]
        assert eng.stats["admissions"] == len(admitted)
        assert (eng.stats["prefill_rows"] + eng.stats["prefix_hit_rows"]
                == sum(r.prompt_len for r in admitted))
    # each case exercises what it is named for
    want = {"chunked": "chunk_calls", "prefix": "prefix_hit_requests",
            "preemption": "preemptions", "priority": "preemptions",
            "cancel": "preemptions"}.get(case.split()[-1])
    if want:
        assert eng.stats[want] > 0
    if case.endswith("prefix"):
        # first payer: reusers pay only their computed suffix
        e = {u: done[u].power.energy["baseline"]["total"] for u in done}
        assert all(e[u] < e[min(done)] for u in done if u != min(done))
    if case == "cancel":
        assert sum(r.finish_reason == "cancelled" for r in done.values()) == 2
    # pages conserved, and the retired energies sum to the trace
    cached = len(eng.prefix) if eng.prefix is not None else 0
    assert eng.cache.n_live == 0
    assert eng.cache.n_free_pages + cached == eng.cache.num_pages - 1
    rep = eng.trace_report()
    # the booked MAC extents too: a re-prefill after preemption grows its
    # prefill sites' (ROADMAP fault 10)
    assert [(s.name, s.shape, s.calls, s.macs) for s in rep.sites] == \
        [(s.name, tuple(s.shape), s.calls, s.macs)
         for s in jeng.trace_report().sites]
    booked = [r.power for r in done.values() if r.power is not None]
    for design in ("baseline", "proposed"):
        np.testing.assert_allclose(
            sum(s.energy(design) for s in rep.sites),
            sum(p.energy[design]["total"] for p in booked), rtol=1e-6)


# ------------------------------------------------- model steps vs JAX
def test_paged_model_steps_match_jax(model):
    """One paged decode step (a dead row, shared pages) and one prefill
    chunk with right padding, on the same pools: logits and the pools
    after the step's in-place writes."""
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(31)
    P, MP = 17, CACHE_LEN // PS
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    pools = rng.standard_normal((2, L, P, PS, kv, hd)).astype(np.float32)
    pages = np.zeros((3, MP), np.int32)
    pages[0, :3] = [1, 2, 3]
    pages[1, :3] = [1, 2, 4]                   # shares pages 1 and 2
    tokens = np.array([[5], [17], [0]])
    positions = np.array([[20], [17], [0]])    # row 2 dead
    weights = lm.compute_weights(params, cfg)

    def port_pools():
        return [(torch.from_numpy(pools[0, i].copy()),
                 torch.from_numpy(pools[1, i].copy())) for i in range(L)]

    def jax_pools():
        return {"head": [], "tail": [], "groups": {
            "b0": (jnp.asarray(pools[0]), jnp.asarray(pools[1]))}}

    def check(got, want, got_pools, want_pools):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= LOGIT_TOL * np.abs(
            want).max()
        jk, jv = want_pools["groups"]["b0"]
        for i, (k, v) in enumerate(got_pools):
            for a, b in ((k, jk[i]), (v, jv[i])):
                b = np.asarray(b)
                assert np.abs(a.numpy() - b).max() <= 2e-6 * np.abs(b).max()

    decode = lm.make_decode_step(cfg, "auto")
    st = port_pools()
    got = decode(weights, st, torch.from_numpy(tokens),
                 torch.from_numpy(positions), torch.from_numpy(pages))
    want, jst = jax.jit(jlm.make_decode_step(jcfg))(
        jparams, jax_pools(), {"tokens": jnp.asarray(tokens, jnp.int32),
                               "positions": jnp.asarray(positions,
                                                        jnp.int32),
                               "pages": jnp.asarray(pages)})
    check(got, want, st, jst)

    toks = np.array([[3, 9, 27, 81, 0, 0]])
    poss = np.array([[16, 17, 18, 19, -1, -1]])
    chunk = lm.make_chunk_prefill_step(cfg)
    st = port_pools()
    got = chunk(weights, st, torch.from_numpy(toks), torch.from_numpy(poss),
                torch.from_numpy(pages[:1]), 20, 16)
    want, jst = jax.jit(jlm.make_chunk_prefill_step(jcfg))(
        jparams, jax_pools(), {"tokens": jnp.asarray(toks, jnp.int32),
                               "positions": jnp.asarray(poss, jnp.int32),
                               "pages": jnp.asarray(pages[:1])},
        np.int32(20))
    check(got, want, st, jst)


# -------------------------------------------------- the port on its own
def test_paged_matches_slot_engine(model):
    """Ample pages, no chunking, no prefix cache: the slot engine's tokens
    (greedy and sampled rows, one generator), energies and trace."""
    prompts = _prompts(8, seed=15)
    sampling = [SamplingParams() if i % 2 == 0
                else SamplingParams(temperature=0.8, top_k=5)
                for i in range(8)]
    paged = _port(model, _paged_cfg(rows=3), power_monitor=True, seed=3)
    slot = _port(model, max_slots=3, power_monitor=True, seed=3)
    got_p = _drain(paged, prompts, sampling=sampling)
    got_s = _drain(slot, prompts, sampling=sampling)
    for uid, r in got_s.items():
        assert got_p[uid].generated == r.generated
        assert got_p[uid].slot == r.slot
        assert got_p[uid].power.energy == r.power.energy
    rp, rs = paged.trace_report(), slot.trace_report()
    assert rp.summary() == rs.summary()


def test_churn_returns_every_page(model):
    eng = _port(model, _paged_cfg(rows=2, pages=16))
    done = _drain(eng, _prompts(7, seed=16), max_new=3)
    assert len(done) == 7 and all(len(r.generated) == 3
                                  for r in done.values())
    assert eng.cache.n_live == 0 and eng.cache.n_free_pages == 15
    assert eng.cache.allocations == 7 and eng.stats["peak_admitted"] <= 2


def test_infeasible_page_footprint_rejected_at_submit(model):
    eng = _port(model, _paged_cfg(rows=2, pages=4))    # 3 usable pages
    with pytest.raises(ValueError, match="cache pages"):
        eng.submit(list(range(30)), max_new_tokens=4)
    with pytest.raises(ValueError, match="scheduling class"):
        eng.submit([1, 2], max_new_tokens=2, klass="nope")
    eng.submit(list(range(20)), max_new_tokens=3)      # 3 pages: fits


def test_admitted_concurrency_beats_slot_engine(model):
    """Equal memory (2 slots x 48 positions = 12 usable pages x 8): short
    prompts all run at once on the paged engine."""
    prompts = _prompts(6, seed=17, lo=5, hi=7)
    slot = _port(model, max_slots=2)
    paged = _port(model, _paged_cfg(rows=6, pages=13))
    got_s, got_p = _drain(slot, prompts), _drain(paged, prompts)
    assert ({u: r.generated for u, r in got_p.items()}
            == {u: r.generated for u, r in got_s.items()})
    assert slot.stats["peak_live"] <= 2
    assert paged.stats["peak_admitted"] > slot.scfg.max_slots
    assert paged.stats["steps"] < slot.stats["steps"]


def test_chunked_prefill_matches_dense_and_keeps_rows_out(model):
    prompts = _prompts(4, seed=18, lo=18, hi=40)
    dense = _drain(_port(model, _paged_cfg(rows=2)), prompts)
    eng = _port(model, _paged_cfg(rows=2, chunk=8))
    seen = []
    inputs = eng.cache.decode_inputs

    def recording():
        out = inputs()
        seen.extend(bool((out[2][row] == TRASH).all())
                    for row in range(eng.cache.max_rows)
                    if eng.cache.reserved[row])
        return out
    eng.cache.decode_inputs = recording
    chunked = _drain(eng, prompts)
    assert ({u: r.generated for u, r in chunked.items()}
            == {u: r.generated for u, r in dense.items()})
    assert eng.stats["chunk_calls"] >= 3 * len(prompts)
    # a row mid-prefill sat beside a decode step, through an all-trash
    # table (its pages are not written)
    assert seen and all(seen)


@pytest.mark.parametrize("arch", MLA_ARCHS)
def test_chunked_mla_under_concurrency(arch):
    """Chunked MLA prefill beside decoding rows (3 rows, chunks of 8),
    held against the port's own runs: the dense (unchunked) paged run on
    the dense-FFN arch, the one-row chunked run on the MoE arch (the
    MoE's capacity is set per call, so a chunk drops other tokens than a
    whole prompt does). Rows mid-prefill stay out of the decode step."""
    model = _model(arch)
    prompts = _prompts(4, seed=18, lo=18, hi=40)
    eng = _port(model, _paged_cfg(rows=3, chunk=8), power_monitor=True)
    chunked = _drain(eng, prompts)
    assert eng.stats["chunk_calls"] >= 3 * len(prompts)
    assert eng.stats["peak_admitted"] > 1
    if model[2].moe is None:
        want = _drain(_port(model, _paged_cfg(rows=3)), prompts)
    else:
        want = _drain(_port(model, _paged_cfg(rows=1, chunk=8)), prompts)
    assert ({u: r.generated for u, r in chunked.items()}
            == {u: r.generated for u, r in want.items()})
    cached = len(eng.prefix) if eng.prefix is not None else 0
    assert eng.cache.n_free_pages + cached == eng.cache.num_pages - 1


def test_class_scheduler_admits_in_jax_order():
    classes = (("a", 0, 3), ("b", 0, 1), ("c", 2, 1))
    ours = ClassScheduler(CACHE_LEN, tuple(SchedClass(*c) for c in classes),
                          page_size=PS, usable_pages=6)
    theirs = JClassScheduler(CACHE_LEN,
                             tuple(JSchedClass(*c) for c in classes),
                             page_size=PS, usable_pages=6)
    rng = np.random.default_rng(19)
    live, admitted = [], 0
    for _ in range(300):
        op = rng.integers(0, 4)
        if op <= 1:
            klass = "abc"[rng.integers(0, 3)]
            n = int(rng.integers(1, 20))
            for s, cls in ((ours, Request), (theirs, JRequest)):
                s.submit(cls(prompt=[1] * n, max_new_tokens=2, klass=klass))
        elif op == 2:
            k = int(rng.integers(1, 3))
            got = [[r.uid for r in s.pop_admissible(k)]
                   for s in (ours, theirs)]
            assert got[0] == got[1]
            live += got[0]
            admitted += len(got[0])
        elif live and rng.random() < 0.5:
            uid = live.pop(int(rng.integers(0, len(live))))
            for s, cls in ((ours, Request), (theirs, JRequest)):
                s.requeue_front(cls(prompt=[1], uid=uid, klass="abc"[uid % 3]))
        else:
            uid = int(rng.integers(0, 60))
            assert ours.cancel(uid) == theirs.cancel(uid)
        assert ours.n_pending == theirs.n_pending
        assert ours.credits == theirs.credits
    assert admitted > 20

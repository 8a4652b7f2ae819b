"""The serving cells: closed-loop clients against the port's serving
engine (``ServeEngine.submit`` / ``step``, slot or paged), power
accounting on, greedy requests.

The window pumps ``engine.step()``; before each step every client
without a request in flight submits its next one. A token's time is the
end of the step that produced it (the engine returns it to the host
there); a request's first token is its time to first token, counted
from its submission. After the window closes no request is sent, and
steps run on until every request sent in the window has its first
token (its wait counts), or a minute has passed.

Correctness: a sample of the finished requests drawn from the seed, the
longest among them (``check.requests``: a number, or ``"all"``). The
plain float32 forward over each prompt and its served tokens gives the
logits at every served position; the widest gap by which a served
token's logit lies below the reference's best is compared. The
accountant's energies per request are worked out again from the
request's tokens; its counts (prompt, new tokens, decode steps) must be
the request's.

Nothing here is particular to one architecture: the configuration's
reference module (``reference`` key) gives the port's architecture as
plain keywords, draws the weights and runs the plain forward.
"""
from __future__ import annotations

import dataclasses
import math
import time
import typing

import torch
from repro_torch.kernels import _build
from repro_torch.models.config import ArchConfig
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.paging import PagingConfig
from repro_torch.serve.request import Request

from perfbench.harness import core, inputs, stats
from perfbench.harness.core import Check
from perfbench.harness.traffic import Traffic
from perfbench.reference import accountant as ACC

GRACE_S = 60.0


class State:
    pass


class _Rec:
    __slots__ = ("req", "client", "submit_t", "times", "seen", "in_window",
                 "prefix")

    def __init__(self, req, client, t, in_window, prefix):
        self.req, self.client, self.submit_t = req, client, t
        self.times: list[float] = []
        self.seen = 0
        self.in_window = in_window
        self.prefix = prefix


def _dataclass(cls, kw: dict):
    """``cls(**kw)`` with every nested dict built into the dataclass its
    field is typed with, and lists made tuples."""
    hints = typing.get_type_hints(cls)
    out = {}
    for k, v in kw.items():
        if isinstance(v, dict):
            sub = [t for t in (typing.get_args(hints[k]) or (hints[k],))
                   if dataclasses.is_dataclass(t)]
            v = _dataclass(sub[0], v)
        elif isinstance(v, list):
            v = tuple(v)
        out[k] = v
    return cls(**out)


def arch_config(cfg: dict) -> ArchConfig:
    """The port's ``ArchConfig`` of a configuration file: the keywords
    its reference module gives, with the file's ``port`` overrides
    (execution knobs) on top."""
    kw = dict(core.reference(cfg).port_arch(cfg), **cfg.get("port", {}))
    return _dataclass(ArchConfig, kw)


def _engine(run, arch, params):
    eng = run.cell["engine"]
    paging = None
    if "paging" in eng:
        p = dict(eng["paging"])
        if p.get("num_pages") == "ample":
            p["num_pages"] = (p["max_rows"] * eng["cache_len"]
                              // p["page_size"] + 1)
        paging = PagingConfig(**p)
    scfg = ServeConfig(max_slots=int(eng.get("max_slots", 4)),
                       cache_len=int(eng["cache_len"]), power_monitor=True,
                       kernel_backend=eng.get("kernel_backend", "auto"),
                       device=run.device, seed=run.seed % (1 << 31),
                       paging=paging)
    return ServeEngine(params, arch, scfg)


def setup(run) -> State:
    cfg = run.config
    st = State()
    if run.device.startswith("cuda"):
        _build.build_all(("power_counters", "zvg_matmul"))
    st.model = core.reference(cfg)
    st.arch = arch_config(cfg)
    st.params = st.model.init_params(cfg, inputs.generator(run.seed,
                                                           run.device, 1))
    st.eng = _engine(run, st.arch, st.params)
    if run.fault:
        _plant(run.fault, st.eng)
    st.traffic = Traffic(run.traffic, run.seed, cfg["vocab_size"])
    st.page_size = run.cell["engine"].get("paging", {}).get("page_size", 1)
    st.recs: dict[int, _Rec] = {}
    st.inflight: dict[int, _Rec] = {}       # client -> its request
    st.finished: list[_Rec] = []
    st.first_of_prefix: dict[int, int] = {}
    _warm(run, st)
    # every client's first request admitted before the window opens
    for c in range(st.traffic.clients):
        _submit(run, st, c, time.perf_counter(), in_window=False)
    while any(not r.req.generated for r in st.inflight.values()):
        _step(run, st, in_window=False)
    run.sync()
    return st


def _plant(fault: str, eng) -> None:
    """Break the timed path underneath (the tests' planted faults): a
    token altered where it is sampled, half of each decode batch's
    logits left out, or a request's energy altered at retirement."""
    if fault == "token":
        sample = eng._sample

        def altered(logits, temp, topk):
            out = sample(logits, temp, topk)
            out[0] = (out[0] + 1) % logits.shape[-1]
            return out
        eng._sample = altered
    elif fault == "half":
        decode = eng._decode

        def halved(*args):
            logits = decode(*args)
            logits[logits.shape[0] // 2:] = 0
            return logits
        eng._decode = halved
    elif fault == "answer":
        finish = eng.accountant.finish

        def skewed(slot, new_tokens):
            rep = finish(slot, new_tokens)
            rep.energy["proposed"]["total"] *= 1.0 + 1e-3
            return rep
        eng.accountant.finish = skewed
    else:
        raise ValueError(f"unknown fault {fault!r}")


def _warm(run, st) -> None:
    """Every prefill bucket the traffic can reach and the decode step, by
    requests of random tokens run to the end (they share no prefix with
    the traffic's)."""
    eng = st.eng
    g = torch.Generator().manual_seed(run.seed % (1 << 63) ^ 0x5EED)
    seen = set()
    for n in st.traffic.prefill_lengths():
        b = eng._bucket(n)
        if b in seen:
            continue
        seen.add(b)
        toks = torch.randint(run.config["vocab_size"], (n,),
                             generator=g).tolist()
        eng.submit(Request(prompt=toks, max_new_tokens=3))
        eng.run()
    if st.traffic.prefixes:
        # the prefix-hit path: a shared prompt twice, at each suffix bucket
        pre = torch.randint(run.config["vocab_size"],
                            (len(st.traffic.prefixes[0]),),
                            generator=g).tolist()
        for n in sorted({eng._bucket(p) for p in st.traffic.prompts}):
            for _ in range(2):
                suf = torch.randint(run.config["vocab_size"], (n,),
                                    generator=g).tolist()
                eng.submit(Request(prompt=pre + suf, max_new_tokens=3))
                eng.run()


def _submit(run, st, client: int, t: float, in_window: bool) -> None:
    prompt, max_new, prefix = st.traffic.next()
    req = st.eng.submit(Request(prompt=prompt, max_new_tokens=max_new))
    rec = _Rec(req, client, t, in_window, prefix)
    st.recs[req.uid] = rec
    if prefix is not None:
        st.first_of_prefix.setdefault(prefix, req.uid)
    st.inflight[client] = rec
    if in_window:
        run.add("attempted")


def _start(st, rec) -> int:
    """The first prompt position the request's prefill computes: 0 for
    the first request sent with its shared prefix, which computes it and
    leaves its full pages in the prefix cache (admission is first come,
    first served, and the cell's ample pool never evicts them); past those
    pages for every later one."""
    if rec.prefix is None or st.first_of_prefix[rec.prefix] == rec.req.uid:
        return 0
    page = st.page_size
    return min(len(st.traffic.prefixes[0]) // page,
               (len(rec.req.prompt) - 1) // page) * page


def _step(run, st, in_window: bool) -> None:
    """One engine step; stamps the tokens it produced with its end."""
    t0 = time.perf_counter()
    with run.span("engine.step"):
        retired = st.eng.step()
    t1 = time.perf_counter()
    admitted = []
    for rec in list(st.inflight.values()):
        n = len(rec.req.generated)
        if n > rec.seen:
            if rec.seen == 0:
                admitted.append(rec)
            rec.times.extend([t1] * (n - rec.seen))
            rec.seen = n
    if in_window:
        run.add("steps")
        for rec in admitted:
            rows = len(rec.req.prompt) - _start(st, rec)
            run.add("prefill_tokens", rows)
            if run.profiling:
                run.note("admitted_rows", rows)
        if admitted:
            run.spans.setdefault("step_admit_per_request", []).append(
                (t1 - t0) / len(admitted))
        else:
            run.spans.setdefault("step_no_admit", []).append(t1 - t0)
    for req in retired:
        rec = st.recs[req.uid]
        st.finished.append(rec)
        if st.inflight.get(rec.client) is rec:
            del st.inflight[rec.client]


def window(run, st: State) -> None:
    t0 = time.perf_counter()
    st.t0 = t0
    while True:
        now = time.perf_counter()
        for c in range(st.traffic.clients):
            if c not in st.inflight:
                _submit(run, st, c, now, in_window=True)
        with run.unit():
            _step(run, st, in_window=True)
        if run.elapsed(t0) >= run.seconds:
            break
    st.t_end = time.perf_counter()
    run.window_s = run.elapsed(t0)
    # every request sent in the window waits for its first token
    grace = st.t_end + GRACE_S
    while (any(r.in_window and not r.req.generated
               for r in st.inflight.values())
           and time.perf_counter() < grace):
        _step(run, st, in_window=False)
    run.counts["failed"] = sum(1 for r in st.recs.values()
                               if r.in_window and not r.req.generated)
    st.tokens = sum(1 for r in st.recs.values() for t in r.times
                    if t0 < t <= st.t_end)
    run.counts["tokens"] = st.tokens


def end_to_end(run, st: State) -> dict:
    # every request sent in the window (also read by the per-layer
    # metric serve.ttft_p95_ms)
    ttft = run.spans.setdefault("ttft", [])
    ttft += [r.times[0] - r.submit_t for r in st.recs.values()
             if r.in_window and r.times]
    # every gap between consecutive tokens of a request, both in the
    # window (read by the per-layer metric serve.itl_p95_ms)
    gaps = run.spans.setdefault("token_gaps", [])
    for r in st.recs.values():
        ts = [t for t in r.times if st.t0 < t <= st.t_end]
        gaps += [b - a for a, b in zip(ts, ts[1:])]
    p95 = stats.percentile(ttft, 95)
    return {"tokens_per_s": st.tokens / run.window_s,
            "ttft_p95_ms": None if p95 is None else p95 * 1e3}


def _sample(run, st) -> list[_Rec]:
    """A sample of the finished requests drawn from the seed, the longest
    among them."""
    pool = [r for r in st.finished if r.req.power is not None]
    n = run.cell["check"]["requests"]
    n = len(pool) if n == "all" else int(n)
    if not pool:
        return []
    longest = max(pool, key=lambda r: len(r.req.prompt)
                  + len(r.req.generated))
    rest = [r for r in pool if r is not longest]
    g = torch.Generator().manual_seed(run.seed % (1 << 63))
    perm = torch.randperm(len(rest), generator=g).tolist()
    return [longest] + [rest[i] for i in perm[:n - 1]]


def _gap(ref_logits: torch.Tensor, tokens: list[int]) -> float:
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, torch.tensor(tokens, device=ref_logits.device)
                            [:, None])[:, 0]
    return float((best - got).max())


def _energy_gap(got: dict, want: dict) -> float:
    gap = 0.0
    for name, comps in want.items():
        for comp, v in comps.items():
            p = float(got.get(name, {}).get(comp, math.nan))
            d = abs(p - v) / max(abs(v), 1e-30)
            gap = max(gap, d if d == d else math.inf)
    return gap


def check(run, st: State) -> list[Check]:
    lim = run.cell["limits"]
    sample = _sample(run, st)
    cfg = run.config
    model = st.model
    st.eng = None
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    logit_gap = energy_gap = fields = 0.0
    c_gap = c_energy = 0.0
    served = 0
    for rec in sample:
        req = rec.req
        gen = list(req.generated)
        toks = list(req.prompt) + gen[:-1]
        at = list(range(len(req.prompt) - 1, len(toks)))
        ref = model.logits(st.params, cfg, toks, at)
        logit_gap = max(logit_gap, _gap(ref, gen))
        served += len(gen)
        rep = req.power
        steps = len(gen) - 1
        fields += float(rep.prompt_tokens != len(req.prompt)
                        or rep.new_tokens != len(gen)
                        or rep.decode_steps != steps
                        or rep.sampled_steps != steps)
        start = _start(st, rec)
        want = ACC.request_energy(st.params, model.embed_scale(cfg),
                                  req.prompt, gen, steps, start)
        energy_gap = max(energy_gap, _energy_gap(rep.energy, want))
        if run.control:
            low = model.logits(st.params, cfg, toks, at, lowp="fp8")
            c_gap = max(c_gap, _gap(ref, low.argmax(dim=-1).tolist()))
            cheap = ACC.request_energy(st.params, model.embed_scale(cfg),
                                       req.prompt, gen, steps, start,
                                       dtype=torch.bfloat16)
            c_energy = max(c_energy, _energy_gap(cheap, want))
    run.counts["judged_requests"] = len(sample)
    run.counts["judged_tokens"] = served
    if not sample:
        logit_gap = energy_gap = fields = math.inf
    if run.control:
        run.control_checks = [
            Check("logit_gap", c_gap, lim["logit_gap"]),
            Check("energy_gap", c_energy, lim["energy_gap"])]
    return [Check("logit_gap", logit_gap, lim["logit_gap"]),
            Check("energy_gap", energy_gap, lim["energy_gap"]),
            Check("report_fields_differ", fields,
                  lim["report_fields_differ"])]

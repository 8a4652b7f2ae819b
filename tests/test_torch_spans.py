"""The port's span recorder (``repro_torch.runtime.spans``) and where the
port opens spans: off it is one shared no-op that calls nothing; on it
keeps nested records with parents and self times; under a profiler every
span is a profiler range. The slot and paged engines open ``serve.step >
serve.admit > serve.prefill > model.*`` and the rest (one ``serve.admit`` an
admission, page pressure too), stamp each request's submit, the start and
the end of its admission, and count admitted rows; the CNN capture and
pricing open theirs. With spans on,
tokens, power reports and the CNN's per-site results are bitwise what
they are with spans off."""
import contextlib

import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.apps.cnn import analysis, nets
from repro_torch.configs import SMOKES
from repro_torch.kernels import launch_counts
from repro_torch.kernels.zvg_matmul import kernel as kz
from repro_torch.models import lm
from repro_torch.runtime import spans
from repro_torch.serve import PagingConfig, Request, ServeConfig, ServeEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _off():
    spans.disable()
    yield
    spans.disable()


class _Calls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_off_is_one_shared_noop_that_calls_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    calls = _Calls()
    with calls:
        for name in ("serve.step", "model.mla", "design.price"):
            s = spans.span(name)
            assert s is spans.NOOP
            with s:
                pass
    assert calls.n == 0
    assert spans.take() == []


def test_records_nest_with_parents_uids_and_self_time():
    spans.enable()
    with spans.span("a"):
        with spans.span("b"):
            with spans.span("c"):
                pass
        with spans.span("b"):
            pass
    recs = spans.take()
    assert [(r.name, r.parent) for r in recs] == [
        ("a", -1), ("b", 0), ("c", 1), ("b", 0)]
    for r in recs:
        assert r.end_ns >= r.start_ns
    summ = spans.summary(recs)
    dur = [(r.end_ns - r.start_ns) / 1e6 for r in recs]
    assert summ["a"]["count"] == 1 and summ["b"]["count"] == 2
    assert summ["a"]["self_ms"] == pytest.approx(dur[0] - dur[1] - dur[3])
    assert summ["b"]["self_ms"] == pytest.approx(dur[1] - dur[2] + dur[3])
    assert summ["c"]["self_ms"] == pytest.approx(summ["c"]["total_ms"])
    assert "a" in spans.format_summary(summ)


def test_take_empties_the_store_and_is_refused_inside_a_span():
    spans.enable()
    with spans.span("x"):
        with pytest.raises(RuntimeError):
            spans.take()
    assert len(spans.take()) == 1
    assert spans.take() == []
    with spans.span("y"):
        pass
    spans.disable()
    assert spans.take() == [] and spans.span("z") is spans.NOOP


@pytest.mark.parametrize("on", [False, True])
def test_profiled_spans_are_profiler_ranges(on):
    if on:
        spans.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("serve.step"):
            with spans.span("model.mlp"):
                torch.ones(4).sum()
    ranges = [e.name for e in prof.events() if e.is_user_annotation]
    assert ranges.count("serve.step") == 1
    assert ranges.count("model.mlp") == 1
    assert [r.name for r in spans.take()] == (["serve.step", "model.mlp"]
                                              if on else [])


def test_launch_counts_read_the_wrappers(monkeypatch):
    monkeypatch.setattr(kz.gated_row_matmul_cuda, "launches", 5)
    monkeypatch.setattr(kz.gated_row_matmul_cuda, "wide_launches", 3)
    monkeypatch.setattr(kz.fused_matmul_counters_cuda, "launches", 2)
    got = launch_counts()
    assert sorted(got) == sorted([f"k{i}" for i in range(1, 9)]
                                 + ["k2_wide"])
    assert got["k2"] == 5 and got["k2_wide"] == 3 and got["k3"] == 2


# --------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def smoke():
    cfg = SMOKES["minicpm3-4b"].with_(compute_dtype="float32")
    return cfg, lm.init_model(cfg, torch.Generator().manual_seed(0))


SHARED = list(range(40, 56))          # four pages of 4


#: pages in the pool: ample, or so few that a decode preempts a row
PAGES = {"slot": None, "paged": 64, "pressure": 10}


def _serve(smoke, kind: str, on: bool):
    cfg, params = smoke
    paging = (PagingConfig(page_size=4, num_pages=PAGES[kind], max_rows=3,
                           prefix_cache=True) if PAGES[kind] else None)
    eng = ServeEngine(params, cfg, ServeConfig(
        max_slots=3, cache_len=48, power_monitor=True, device="cpu",
        paging=paging))
    g = torch.Generator().manual_seed(5)
    reqs = []
    for i in range(5):
        tail = torch.randint(256, (3 + 2 * i,), generator=g).tolist()
        reqs.append(eng.submit(Request(prompt=SHARED + tail,
                                       max_new_tokens=3 + i % 2)))
    if on:
        spans.enable()
    eng.run()
    recs = spans.take()
    spans.disable()
    return eng, reqs, recs


@pytest.mark.parametrize("kind", list(PAGES))
def test_engine_spans_stamps_and_rows(smoke, kind):
    eng, reqs, recs = _serve(smoke, kind, on=True)
    paged = kind != "slot"
    names = {r.name for r in recs}
    assert {"serve.step", "serve.admit", "serve.prefill",
            "serve.first_token", "serve.account_prompt", "serve.decode",
            "serve.account_decode", "serve.forward", "serve.sample",
            "serve.retire", "model.embed", "model.norm", "model.mla",
            "model.mlp", "model.head"} <= names
    # a prefix hit prefills its suffix as a chunk against its pages
    assert ("serve.pages" in names) == paged
    assert ("serve.chunk_prefill" in names) == paged
    parent = lambda r: recs[r.parent].name if r.parent >= 0 else None
    for r in recs:
        if r.name == "serve.step":
            assert r.parent == -1
        elif r.name in ("serve.admit", "serve.decode", "serve.pages"):
            assert parent(r) == "serve.step"
        elif r.name in ("serve.prefill", "serve.chunk_prefill",
                        "serve.first_token", "serve.account_prompt"):
            assert parent(r) == "serve.admit"
        elif r.name in ("serve.account_decode", "serve.forward",
                        "serve.sample"):
            assert parent(r) == "serve.decode"
        elif r.name.startswith("model."):
            assert parent(r) in ("serve.prefill", "serve.chunk_prefill",
                                 "serve.forward")
    st = eng.stats
    # one serve.admit an admission, a preempted request's re-admission
    # too; an attempt that yields for pages opens serve.pages alone
    assert sum(r.name == "serve.admit" for r in recs) == st["admissions"]
    assert sum(r.name == "serve.retire" for r in recs) == len(reqs)
    assert st["admissions"] == len(reqs) + st.get("preemptions", 0)
    assert bool(st.get("preemptions")) == (kind == "pressure")
    for q in reqs:
        assert 0 < q.t_submit <= q.t_admit <= q.t_first
    if kind == "pressure":
        return
    assert (st["prefill_rows"] + st["prefix_hit_rows"]
            == sum(q.prompt_len for q in reqs))
    # the first sender computes the shared pages, every later one hits
    # them: what the benchmark harness infers from the order it sent in
    assert st["prefix_hit_rows"] == (len(SHARED) * (len(reqs) - 1)
                                     if paged else 0)


@pytest.mark.parametrize("kind", list(PAGES))
def test_spans_change_no_token_or_energy(smoke, kind):
    _, off, _ = _serve(smoke, kind, on=False)
    _, on, recs = _serve(smoke, kind, on=True)
    assert recs
    for a, b in zip(off, on):
        assert a.generated == b.generated
        assert a.power.energy == b.power.energy
        assert (a.power.prompt_tokens, a.power.decode_steps) == (
            b.power.prompt_tokens, b.power.decode_steps)


def test_cnn_spans_and_results_equal_on_and_off():
    images = nets.synthetic_images(1, 32, seed=3)
    params = nets.init_params("mobilenet", 0)

    def analyse():
        traces = nets.forward_with_traces("mobilenet", images,
                                          params=params)
        layers = [analysis.analyze_trace(t) for t in traces[:4]]
        analysis.select_network(layers)
        return traces, layers, analysis.network_summary(layers)

    t0, l0, s0 = analyse()
    spans.enable()
    t1, l1, s1 = analyse()
    recs = spans.take()
    for a, b in zip(t0, t1):
        assert torch.equal(a.A, b.A) and torch.equal(a.W, b.W)
    assert [x.designs for x in l0] == [x.designs for x in l1]
    assert s0 == s1
    names = [r.name for r in recs]
    assert names.count("cnn.capture") == 1
    assert names.count("cnn.site") == 4
    assert names.count("cnn.select") == 2
    assert {"cnn.im2col", "cnn.conv", "cnn.record", "sa.edge_streams",
            "sa.counters", "sa.lane_sums", "sa.facts",
            "design.price"} <= set(names)
    for r in recs:
        if r.name in ("cnn.im2col", "cnn.conv", "cnn.record"):
            assert recs[r.parent].name == "cnn.capture"
        if r.name in ("sa.edge_streams", "sa.counters", "sa.facts",
                      "design.price"):
            assert recs[r.parent].name == "cnn.site"


def test_serve_cli_prints_the_spans(capsys):
    from repro_torch.serve.__main__ import main

    main(["--smoke", "--device", "cpu", "--spans", "--requests", "3",
          "--max-new", "5"])
    out = capsys.readouterr().out
    assert "spans over the run (3 admissions" in out
    for name in ("serve.step", "serve.decode", "model.attn"):
        assert any(line.split()[:1] == [name] for line in out.splitlines())
    assert spans.span("z") is spans.NOOP


def test_spans_nest_under_exceptions():
    spans.enable()
    with contextlib.suppress(ValueError):
        with spans.span("outer"):
            with spans.span("inner"):
                raise ValueError
    recs = spans.take()
    assert [(r.name, r.parent) for r in recs] == [("outer", -1),
                                                  ("inner", 0)]

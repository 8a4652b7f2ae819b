"""The program's spans in a profile, and the span tool at a size the CPU
holds: a kernel is charged to the innermost program span that holds its
launch call, an idle interval of the card to the spans that hold it
(split where a span ends), and kernels no span holds to ``"(none)"``;
the tool runs a serving cell traced with the recorder on and reads the
engine's own counters and stamps, which agree with what the harness
infers from the order it sent requests in."""
import copy
import sys
import types

import pytest
from torch.autograd import DeviceType

from perfbench.harness import attribution, core
from perfbench.tests.test_perfbench_generic import CFG, NAME, _module
from perfbench.tools import spans as tool


def _evt(name, start, end, device=DeviceType.CPU, id=0, linked=0,
         annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=device, id=id, linked_correlation_id=linked,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def _kernel(name, start, end, id, linked=0):
    return _evt(name, start, end, DeviceType.CUDA, id=id, linked=linked)


def _trace():
    """Host: engine.step [0, 100] > serve.decode [5, 95] > model.mla
    [10, 40], serve.sample [60, 90]; a harness span cnn.count_price
    [200, 300]. Device: a kernel launched inside model.mla (its runtime
    call at 12), one whose only link is its host op (at 62, inside
    serve.sample), one launched outside any program span (at 2), one with
    no link at all."""
    return [
        _evt("engine.step", 0, 100, annotation=True),
        _evt("serve.decode", 5, 95, annotation=True),
        _evt("model.mla", 10, 40, annotation=True),
        _evt("serve.sample", 60, 90, annotation=True),
        _evt("cnn.count_price", 200, 300, annotation=True),
        _evt("serve.decode", 5, 95, DeviceType.CUDA, annotation=True),
        _evt("cudaLaunchKernel", 12, 13, id=501),
        _evt("aten::mm", 61, 70, id=77),
        _evt("cudaLaunchKernel", 2, 3, id=502),
        _kernel("void mla_kernel<float>(float*)", 20, 30, id=501),
        _kernel("elementwise_kernel", 50, 70, id=900, linked=77),
        _kernel("reduce_kernel", 80, 85, id=502),
        _kernel("sort_kernel", 210, 220, id=999),
    ]


def test_kernels_go_to_the_span_of_their_launch():
    att = attribution.attribute(_trace(), attribution.is_program)
    dev = att["device"]
    assert dev["total_s"] == pytest.approx(45e-6)
    assert dev["by_span"] == pytest.approx({
        "model.mla": 10e-6, "serve.sample": 20e-6, "(none)": 15e-6})
    assert dev["in_span"]["serve.decode"] == pytest.approx(30e-6)
    assert dev["kernels_by_span"]["model.mla"] == pytest.approx(
        {"mla_kernel": 10e-6})
    assert att["linked"] == {"launch": 2, "op": 1, "none": 1}


def test_idle_goes_to_the_spans_that_hold_it():
    att = attribution.attribute(_trace(), attribution.is_program)
    idle = att["idle"]
    # gaps between merged busy intervals: [30, 50], [70, 80], [85, 210]
    assert idle["total_s"] == pytest.approx(155e-6)
    assert idle["by_span"] == pytest.approx({
        "model.mla": 10e-6, "serve.decode": 10e-6 + 5e-6,
        "serve.sample": 10e-6 + 5e-6, "(none)": 115e-6})
    assert idle["in_span"]["serve.decode"] == pytest.approx(40e-6)
    # with every annotation a span, the harness's own hold the rest
    every = attribution.attribute(_trace())["idle"]["by_span"]
    assert every["engine.step"] == pytest.approx(5e-6)
    assert every["cnn.count_price"] == pytest.approx(10e-6)


def test_the_tool_reads_the_engine_at_cpu_size(monkeypatch):
    monkeypatch.setitem(sys.modules, NAME, _module())
    files = copy.deepcopy(core.cell_files("minicpm3.serve.paged_prefix"))
    files["config"] = dict(CFG)
    t = dict(files["traffic"], clients=3, pool=16, strata=1,
             prefixes={"count": 2, "length": 16})
    t["prompt"] = dict(t["prompt"], lo=4, hi=12)
    t["output"] = dict(t["output"], lo=2, hi=4)
    files["traffic"] = t
    files["cell"]["engine"] = {
        "cache_len": 64, "kernel_backend": "auto",
        "paging": {"page_size": 4, "max_rows": 3, "prefix_cache": True,
                   "num_pages": "ample"}}
    files["cell"]["trace_skip"] = 0
    files["cell"]["trace_units"] = 2
    monkeypatch.setattr(core, "cell_files", lambda name, *a: files)
    out = tool.run_one(core.benchmark(), "minicpm3.serve.paged_prefix",
                       2 ** 31 + 91, 0.5, True, False, "cpu")
    eng = out["engine"]
    assert eng["stats_window"]["admissions"] > 0
    # the engine's rows computed at admission are the rows the harness
    # infers from the order it sent requests in (first come, first served)
    assert (eng["stats_window"]["prefill_rows"]
            == eng["harness_prefill_tokens"])
    assert eng["stats_window"]["prefix_hit_rows"] > 0
    would = out["would_read"]
    assert 0 < would["serve.prefix_hit_share"] < 100
    assert would["serve.queue_wait_p95_ms"] >= 0
    assert {"serve.step", "serve.admit", "serve.pages",
            "model.attn"} <= set(out["spans"])
    split = eng["ttft_split"]
    assert split["ttft"]["n"] > 0 and split["queue"]["n"] == split[
        "ttft"]["n"]
    # the CPU profile holds no device time to put down
    assert out["profiled"]["device"]["total_s"] == 0
    # an untraced run of the same cell keeps the result's keys
    res = core.run_cell(core.benchmark(), "minicpm3.serve.paged_prefix",
                        2 ** 31 + 92, 0.3, False, "cpu", files=files)
    assert set(res) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}


def test_the_quantities_read_what_the_run_holds():
    att = attribution.attribute(_trace(), attribution.is_program)
    assert attribution.named_share(att) == pytest.approx(100 * 30 / 45)
    # idle inside model.mla, the one model.* span: 10 us over 2 steps
    assert attribution.dispatch_idle_ms(att, 2) == pytest.approx(5e-3)
    assert attribution.stream_prep_device_ms(att, 2) is None
    assert attribution.prefill_device_ms_per_1k_rows(
        att, {"prefill_rows": 512}) is None
    assert attribution.prefix_hit_share(
        {"prefill_rows": 30, "prefix_hit_rows": 90}) == pytest.approx(75)
    assert attribution.prefix_hit_share({"prefill_rows": 0}) is None
    req = types.SimpleNamespace
    waits = [req(t_submit=0, t_admit=k * 10 ** 6) for k in range(1, 21)]
    assert attribution.queue_wait_p95_ms(waits) == pytest.approx(19.05)
    assert attribution.queue_wait_p95_ms([req(t_submit=5, t_admit=0)]) \
        is None
    rec = types.SimpleNamespace
    records = [rec(name="design.price", start_ns=s, end_ns=s + d)
               for s, d in ((10, 2e6), (20, 1e6), (110, 4e6))]
    assert attribution.price_host_ms(records, [(0, 100), (100, 200),
                                               (200, 300)]) == 3.0
    assert attribution.price_host_ms([], [(0, 100)]) is None

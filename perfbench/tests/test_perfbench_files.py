"""The benchmark's files load and hold together: every cell's
configuration, traffic, driver and reference exist, every metric has a
reader, names and units are of the contract's characters, and the
configurations are the port's own."""
import json
import re

import pytest

from perfbench.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return core.benchmark()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"] + bench["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", [
    "resnet50.analyze.b256", "minicpm3.serve.decode",
    "minicpm3.serve.prefill", "minicpm3.serve.paged_prefix"])
def test_cell_files_load(bench, cell):
    w = {x["name"]: x for x in bench["workloads"]}[cell]
    files = core.cell_files(cell)
    assert files["cell"]["config"] == w["config"]
    assert files["cell"]["traffic"] == w["traffic"]
    assert files["cell"]["why"] == w["why"]
    assert core.driver(files["config"]).setup
    ref = core.BENCH_DIR / "reference" / f"{files['config']['reference']}.py"
    assert ref.is_file()
    e2e = core.metrics_of(bench, cell, False)
    layer = core.metrics_of(bench, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in {x["name"] for x in e2e}
        assert core.reader(m["name"]).read


def test_configs_listed_and_used(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        assert core.load_json(core.ROOT / c["file"])["name"] == c["name"]
        assert c["reduced"] == []


def test_minicpm3_config_is_the_ports():
    from repro_torch.configs import minicpm3_4b
    from perfbench.drivers import serve_lm

    cfg = core.load_json(core.BENCH_DIR / "configs" / "minicpm3-4b.json")
    assert serve_lm.arch_config(cfg) == minicpm3_4b.CONFIG


def test_resnet50_table_is_the_ports():
    from repro_torch.apps.cnn import nets
    from perfbench.reference import resnet50 as R

    port = [(s.name, s.kind, s.kernel, s.stride, s.cin, s.cout, s.relu)
            for s in nets.resnet50_specs()]
    ours = [(s.name, s.kind, s.kernel, s.stride, s.cin, s.cout, s.relu)
            for s in R.specs()]
    assert ours == port


def test_design_menu_is_the_ports():
    from repro_torch import design as D
    from perfbench.reference import sa

    cfg = core.load_json(core.BENCH_DIR / "configs" / "resnet50.json")
    port = D.named_designs()
    assert list(port) == cfg["designs"] == [d["name"] for d in sa.NAMED]
    for d in sa.NAMED:
        p = port[d["name"]]
        assert (p.west.bic, p.west.zvg) == d["west"]
        assert (p.north.bic, p.north.zvg) == d["north"]


TRAFFIC_KEYS = {"kind", "source", "follows", "departs", "clients", "prompt",
                "output", "prefixes", "pool", "strata"}


@pytest.mark.parametrize("traffic", ["chat_closed128", "longdoc_closed8",
                                     "sysprompt_closed32"])
def test_serving_traffic_names_its_source(traffic):
    spec = core.load_json(core.BENCH_DIR / "traffic" / f"{traffic}.json")
    assert set(spec) <= TRAFFIC_KEYS
    for key in ("source", "follows", "departs"):
        assert isinstance(spec[key], str) and spec[key]
    assert "arXiv:" in spec["source"]
    assert spec["pool"] % spec.get("strata", 1) == 0

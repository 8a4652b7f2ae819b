"""The port's windowed telemetry and closed-loop actuation
(``repro_torch.serve.telemetry``, the accountant's retirement records and
swap epochs in ``repro_torch.serve.power``) against the live JAX package,
case for case with ``tests/test_serve_telemetry.py``.

Each served case runs the same traffic through both packages on the same
weights (the JAX scenario's sparsified smoke model, carried across by
``models.convert``), the port with ``kernel_backend="auto"`` on the CPU
(the kernels' plain versions). Held against JAX:

* greedy tokens and the windows' requests are equal;
* per window and site, every counted key (pipeline toggles ``h/``/``v/``,
  zero counts) is bitwise equal; the priced energy keys
  ``e/<design>/<component>`` agree within rtol 1e-6 (the frameworks'
  float32 pricing rounds the multiplier energy apart in the last bits);
* the flip and swap timelines are equal (window, site, designs, epoch),
  their margins, deltas and savings tracks within rtol 1e-6;
* records replay across packages: the port's dumps load with
  ``repro.serve.telemetry.load_records`` and the JAX dumps in the port,
  both replay to bitwise the same timeline (replays price host floats),
  and the two CLIs print the same table for one records file.

The port's own invariants are those of the JAX tests: windows replay to
``trace_report()`` bit for bit, flips and damping, actuated sums and
replays bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import SMOKES as JSMOKES
from repro.design import select as jselect
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.serve import PagingConfig as JPagingConfig
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import power as jpower
from repro.serve import telemetry as jtel
from repro.serve.telemetry import scenarios as jscen
from repro_torch.configs import SMOKES
from repro_torch.core import monitor
from repro_torch.design.select import select_counters, select_sites
from repro_torch.models import convert
from repro_torch.serve import (PagingConfig, ServeConfig, ServeEngine,
                               ServeTelemetry, TelemetryConfig,
                               WindowedRegistry, power)
from repro_torch.serve.telemetry import load_records
from repro_torch.serve.telemetry import scenarios as scen

RTOL = 1e-6


def _report_bytes(report) -> str:
    return json.dumps(report.to_json_dict(), sort_keys=True)


def _port_params(jparams, arch):
    tree = jax.tree.map(lambda p: np.asarray(p.value), jparams,
                        is_leaf=is_param)
    return convert.params_from_jax(
        tree, SMOKES[arch].with_(compute_dtype="float32"))


def _pair(name, quick=True, **knobs):
    """One scenario served by both packages on the JAX scenario's
    (sparsified) weights: ``(jax run, port run)``."""
    jout = jscen.run_scenario(name, tcfg=jtel.TelemetryConfig(**knobs),
                              quick=quick)
    out = scen.run_scenario(
        name, tcfg=TelemetryConfig(**knobs), quick=quick, device="cpu",
        params=_port_params(jout["engine"].params,
                            scen.SCENARIOS[name].arch))
    return jout, out


def _close(got, want, ctx):
    np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=ctx)


def _same_counters(got: dict, want: dict, ctx: str):
    """Site -> flat counter sums: counted keys bitwise, energies 1e-6."""
    assert got.keys() == want.keys(), ctx
    for site, c in want.items():
        assert got[site].keys() == c.keys(), (ctx, site)
        for k, v in c.items():
            if k.startswith("e/"):
                _close(got[site][k], v, f"{ctx} {site} {k}")
            else:
                assert got[site][k] == v, (ctx, site, k)


def _same_windows(reg, jreg, ctx="windows"):
    assert reg.n_retired == jreg.n_retired
    pw, jw = reg.closed_windows(), jreg.closed_windows()
    assert [(w.index, w.seqs, w.uids, w.partial) for w in pw] == \
        [(w.index, w.seqs, w.uids, w.partial) for w in jw]
    for w, v in zip(pw, jw):
        _same_counters(w.site_counters(), v.site_counters(),
                       f"{ctx}[{w.index}]")


def _same_timeline(tl, jtl, exact=False):
    """Equal decisions; floats bitwise (``exact``: the same records
    replayed) or within rtol 1e-6 (two served runs)."""
    assert len(tl.windows) == len(jtl.windows)
    for w, v in zip(tl.windows, jtl.windows):
        assert (w.window, w.n_requests, w.new_tokens, w.partial,
                w.choices, w.raw_choices) == \
            (v.window, v.n_requests, v.new_tokens, v.partial, v.choices,
             v.raw_choices)
        assert [(f.window, f.site, f.old, f.new) for f in w.flips] == \
            [(f.window, f.site, f.old, f.new) for f in v.flips]
    assert [(s.epoch, s.window, s.sites) for s in tl.swaps] == \
        [(s.epoch, s.window, s.sites) for s in jtl.swaps]
    assert tl.oracle_choices == jtl.oracle_choices
    if exact:
        assert json.dumps(tl.to_json_dict(), sort_keys=True) == \
            json.dumps(jtl.to_json_dict(), sort_keys=True)
        return
    for w, v in zip(tl.windows, jtl.windows):
        assert w.energy.keys() == v.energy.keys()
        for k in v.energy:
            _close(w.energy[k], v.energy[k], f"window {w.window} {k}")
        for f, g in zip(w.flips, v.flips):
            # a relative margin of two energies, each within rtol
            assert abs(f.margin - g.margin) <= 4 * RTOL, (f, g)
    for s, t in zip(tl.swaps, jtl.swaps):
        scale = max(abs(d) for d in t.deltas.values())
        for site, d in t.deltas.items():
            assert abs(s.deltas[site] - d) <= 1e-4 * scale, (s, t)
    sm, jsm = tl.summary(), jtl.summary()
    for k, v in jsm.items():
        if k.startswith("saving_"):
            assert abs(sm[k] - v) <= 4 * RTOL, k
        else:
            assert sm[k] == v, k


def _tokens(finished):
    return {r.uid: r.generated for r in finished}


@pytest.fixture(scope="module")
def shift_pair():
    """The two-phase shift scenario, served once by each package."""
    jout, out = _pair("shift", window=4)
    assert _tokens(out["finished"]) == _tokens(jout["finished"])
    return jout, out


@pytest.fixture(scope="module")
def shift_run(shift_pair):
    return shift_pair[1]


@pytest.fixture(scope="module")
def shift_records(shift_run):
    reg = shift_run["engine"].telemetry.registry
    return reg.records, reg.mcfg


def _jax_records(records):
    return [jpower.RetirementRecord.from_json_dict(r.to_json_dict())
            for r in records]


def _jax_mcfg():
    return jscen.scenario_monitor()


# --------------------------------------------------------- window sums
def _serve_with_telemetry(port: bool, paged: bool, sample_every: int,
                          window: int, stride):
    """The JAX test's mixed workload through either package."""
    jcfg = JSMOKES["qwen1.5-0.5b"].with_(compute_dtype="float32")
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    jscen.sparsify_embeddings(jparams, (0, 64), 0.9)
    if port:
        cfg = SMOKES["qwen1.5-0.5b"].with_(compute_dtype="float32")
        eng = ServeEngine(
            _port_params(jparams, "qwen1.5-0.5b"), cfg, ServeConfig(
                max_slots=2, cache_len=48, power_monitor=True,
                monitor=scen.scenario_monitor(),
                power_sample_every=sample_every,
                telemetry=TelemetryConfig(window=window, stride=stride),
                paging=(PagingConfig(page_size=8, num_pages=13, max_rows=4)
                        if paged else None), device="cpu"))
    else:
        eng = JServeEngine(jparams, jcfg, JServeConfig(
            max_slots=2, cache_len=48, power_monitor=True,
            monitor=jscen.scenario_monitor(),
            power_sample_every=sample_every,
            telemetry=jtel.TelemetryConfig(window=window, stride=stride),
            paging=(JPagingConfig(page_size=8, num_pages=13, max_rows=4)
                    if paged else None)))
    rng = np.random.default_rng(7)
    for lo, hi in ((0, 64), (64, 256), (0, 64), (64, 256), (0, 256),
                   (64, 256), (0, 64)):
        eng.submit(list(map(int, rng.integers(lo, hi,
                                              int(rng.integers(4, 14))))),
                   max_new_tokens=4)
    done = eng.run()
    eng.telemetry.finalize()
    return eng, done


@pytest.mark.parametrize("paged,sample_every,stride", [
    (False, 1, None),      # slot, every step, tumbling
    (False, 3, 2),         # slot, sampled counters, sliding overlap
    (True, 2, None),       # paged engine, sampled, tumbling
])
def test_window_sums_bitexact(paged, sample_every, stride):
    """Windows replay to the serve-wide report bit for bit -- either
    engine, any sampling cadence, tumbling or sliding -- and hold the
    JAX engine's windows."""
    eng, done = _serve_with_telemetry(True, paged, sample_every, 3, stride)
    jeng, jdone = _serve_with_telemetry(False, paged, sample_every, 3,
                                        stride)
    reg = eng.telemetry.registry
    assert reg.n_retired == 7
    merged = reg.merged_report(model=f"serve/{eng.cfg.name}")
    assert _report_bytes(merged) == _report_bytes(eng.trace_report())
    assert _tokens(done) == _tokens(jdone)
    _same_windows(reg, jeng.telemetry.registry)
    _same_timeline(eng.telemetry.timeline, jeng.telemetry.timeline)


def test_rewindowing_any_geometry_bitexact(shift_records):
    """Offline re-windowing of the same records keeps the invariant for
    every (window, stride) geometry, and the JAX registry fed the same
    records windows them to bitwise the same counters."""
    records, mcfg = shift_records
    jrecords = _jax_records(records)
    want = None

    @settings(max_examples=8)
    @given(st.tuples(st.integers(1, 6), st.integers(1, 6)))
    def prop(geom):
        nonlocal want
        window, stride = max(geom), min(geom)   # stride <= window
        reg = WindowedRegistry(TelemetryConfig(window=window,
                                               stride=stride), mcfg)
        jreg = jtel.WindowedRegistry(jtel.TelemetryConfig(
            window=window, stride=stride), _jax_mcfg())
        for rec, jrec in zip(records, jrecords):
            reg.observe(rec)
            jreg.observe(jrec)
        reg.flush()
        jreg.flush()
        got = _report_bytes(reg.merged_report())
        if want is None:
            want = got
        assert got == want
        if stride == window:
            assert sum(w.n_requests for w in reg.windows) == len(records)
        assert [(w.seqs, w.partial) for w in reg.windows] == \
            [(w.seqs, w.partial) for w in jreg.windows]
        for w, v in zip(reg.windows, jreg.windows):
            assert w.site_counters() == v.site_counters()

    prop()


def test_windows_are_whole_requests(shift_pair):
    """No request is split across a window boundary, and the windows
    hold the JAX run's requests and counters."""
    jout, out = shift_pair
    reg = out["engine"].telemetry.registry
    seen = [u for w in reg.windows for u in w.uids]
    assert len(seen) == len(set(seen)) == reg.n_retired
    _same_windows(reg, jout["engine"].telemetry.registry)


# ------------------------------------------------------------ the flip
def test_scripted_shift_flips(shift_pair):
    """The code->chat phase boundary flips the prefill winner from
    mant-exp to bic-west, as in the JAX run."""
    jout, out = shift_pair
    tl = out["timeline"]
    assert tl.n_flips >= 1
    prefill_flips = [f for f in tl.flip_events
                     if f.site.startswith("prefill/")]
    assert prefill_flips, f"no prefill flip in {tl.flip_events}"
    for f in prefill_flips:
        assert (f.old, f.new) == ("mant-exp", "bic-west")
        assert f.margin > 0
    assert all(f.window >= 1 for f in tl.flip_events)
    _same_timeline(tl, jout["timeline"])


def test_savings_tracks_order(shift_pair):
    jout, out = shift_pair
    sm = out["timeline"].summary()
    assert sm["saving_online"] >= sm["saving_fixed"] > 0
    assert sm["saving_oracle"] > 0
    assert set(sm["oracle_choices"]) == set(
        out["timeline"].windows[0].choices)
    assert sm["oracle_choices"] == jout["timeline"].summary()[
        "oracle_choices"]


def test_dwell_runs_cover_windows(shift_pair):
    jout, out = shift_pair
    tl = out["timeline"]
    for site, runs in tl.dwell_times().items():
        assert sum(n for _, n in runs) == len(tl.windows)
    assert tl.dwell_times() == jout["timeline"].dwell_times()


def _replay(records, mcfg, **knobs):
    telem = ServeTelemetry(TelemetryConfig(**knobs), mcfg)
    for rec in records:
        telem.on_retire(rec)
    return telem.finalize()


def _jreplay(records, **knobs):
    telem = jtel.ServeTelemetry(jtel.TelemetryConfig(**knobs), _jax_mcfg())
    for rec in _jax_records(records):
        telem.on_retire(rec)
    return telem.finalize()


def test_hysteresis_damps_flips(shift_records):
    records, mcfg = shift_records
    tl = _replay(records, mcfg, window=4, hysteresis=0.5)
    assert tl.n_flips == 0
    raw = {w.raw_choices["prefill/layer0/wq"] for w in tl.windows}
    assert len(raw) > 1
    first = tl.windows[0].choices
    assert all(w.choices == first for w in tl.windows)
    _same_timeline(tl, _jreplay(records, window=4, hysteresis=0.5),
                   exact=True)


def test_min_dwell_damps_flips(shift_records):
    records, mcfg = shift_records
    free = _replay(records, mcfg, window=2)
    assert free.n_flips >= 1
    held = _replay(records, mcfg, window=2, min_dwell=100)
    assert held.n_flips == 0
    _same_timeline(free, _jreplay(records, window=2), exact=True)
    _same_timeline(held, _jreplay(records, window=2, min_dwell=100),
                   exact=True)


def test_candidate_subset_and_validation(shift_records):
    records, mcfg = shift_records
    tl = _replay(records, mcfg, window=4,
                 candidates=("baseline", "proposed"))
    used = {c for w in tl.windows for c in w.choices.values()}
    assert used <= {"baseline", "proposed"}
    _same_timeline(tl, _jreplay(records, window=4,
                                candidates=("baseline", "proposed")),
                   exact=True)
    for fn in (lambda: _replay(records, mcfg, window=4,
                               candidates=("nope",)),
               lambda: _jreplay(records, window=4, candidates=("nope",))):
        with pytest.raises(ValueError, match="not in the monitor's design"):
            fn()


@pytest.mark.parametrize("kw,match", [
    (dict(window=4, stride=5), "stride"), (dict(window=0), "window"),
    (dict(min_dwell=0), "min_dwell"), (dict(hysteresis=-0.1), "hysteresis")])
def test_config_validation(kw, match):
    """Each invalid knob raises the JAX package's message."""
    with pytest.raises(ValueError, match=match) as ours:
        TelemetryConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jtel.TelemetryConfig(**kw)
    assert str(ours.value) == str(theirs.value)
    assert TelemetryConfig(window=4, stride=2).eff_stride == \
        jtel.TelemetryConfig(window=4, stride=2).eff_stride == 2


def test_telemetry_requires_power_monitor():
    """Refused at config construction, with the JAX package's message
    naming both fields."""
    with pytest.raises(ValueError) as ei:
        ServeConfig(max_slots=2, cache_len=48, device="cpu",
                    telemetry=TelemetryConfig())
    msg = str(ei.value)
    assert "ServeConfig.telemetry" in msg and "power_monitor=True" in msg
    with pytest.raises(ValueError) as ej:
        JServeConfig(max_slots=2, cache_len=48,
                     telemetry=jtel.TelemetryConfig())
    assert msg == str(ej.value)


# ----------------------------------------------------- replay / serde
def test_records_roundtrip_and_cli_replay(shift_pair, tmp_path):
    """dump_records -> CLI replay reproduces the timeline bit for bit,
    the JAX run's timeline within rtol, and the registry refuses feeds
    after a flush."""
    jout, shift_run = shift_pair
    reg = shift_run["engine"].telemetry.registry
    rec_path = tmp_path / "records.json"
    reg.dump_records(str(rec_path))
    meta, records = load_records(str(rec_path))
    assert meta["reference"] == "baseline"
    assert len(records) == reg.n_retired

    from repro_torch.serve.telemetry.__main__ import main as cli_main
    out = tmp_path / "timeline.json"
    csv = tmp_path / "timeline.csv"
    assert cli_main(["--replay", str(rec_path), "--window", "4",
                     "--json", str(out), "--csv", str(csv)]) == 0
    direct = shift_run["timeline"].to_json_dict()
    replayed = json.loads(out.read_text())
    assert (json.dumps(replayed, sort_keys=True)
            == json.dumps(direct, sort_keys=True))
    rows = csv.read_text().strip().splitlines()
    n_sites = len(shift_run["timeline"].windows[0].choices)
    assert len(rows) == 1 + n_sites * len(direct["windows"])
    _same_timeline(shift_run["timeline"], jout["timeline"])

    with pytest.raises(RuntimeError, match="flushed"):
        reg.observe(records[0])
    with pytest.raises(ValueError, match="not a telemetry records"):
        bad = tmp_path / "bad.json"
        bad.write_text('{"schema": "other"}')
        load_records(str(bad))


def test_telemetry_report_shape(shift_pair):
    jout, out = shift_pair
    rep, jrep = out["report"], jout["report"]
    assert rep["schema"] == jrep["schema"] == \
        "repro.serve.telemetry/report/v1"
    assert rep["n_retired"] == sum(w["n_requests"]
                                   for w in rep["windows"])
    assert (rep["config"], rep["designs"], rep["n_retired"],
            rep["windows"]) == (jrep["config"], jrep["designs"],
                                jrep["n_retired"], jrep["windows"])
    tl = rep["timeline"]
    assert tl["schema"] == jrep["timeline"]["schema"] == \
        "repro.serve.telemetry/timeline/v2"
    assert tl["summary"]["n_flips"] == len(tl["flips"])
    assert tl["summary"]["n_swaps"] == len(tl["swaps"]) == 0
    assert tl.keys() == jrep["timeline"].keys()


# ------------------------------------------------- selection coherence
def test_select_counters_matches_select_sites(shift_run):
    """Counter-delta selection and energy-level selection agree on the
    same totals, and the JAX selection on them is bitwise the port's."""
    reg = shift_run["engine"].telemetry.registry
    merged: dict = {}
    for rec in reg.records:
        for sr in rec.sites:
            acc = merged.setdefault(sr.site, {})
            for k, v in sr.counters.items():
                if k != "zero_fraction":
                    acc[k] = acc.get(k, 0.0) + float(v)
    a = select_counters(merged)
    b = select_sites({site: monitor.counters_to_energy(dict(c))
                      for site, c in merged.items()})
    assert a.choices == b.choices
    assert a.saving_total == b.saving_total
    j = jselect.select_counters(merged)
    assert (a.choices, a.saving_total) == (j.choices, j.saving_total)


# ------------------------------------------------------- MoE scenario
def test_moe_drift_scenario_serves():
    """The phi3.5-moe smoke config serves under telemetry with the JAX
    run's tokens, windows and timeline; its monitored sites are the
    attention projections."""
    jout, out = _pair("moe-drift", window=3)
    tl = out["timeline"]
    assert out["engine"].cfg.name == "phi3.5-moe-42b-a6.6b"
    assert len(tl.windows) >= 2
    sites = {s for w in tl.windows for s in w.choices}
    assert sites == {"prefill/layer0/wq", "decode/layer0/wq"}
    reg = out["engine"].telemetry.registry
    assert _report_bytes(reg.merged_report(
        model=f"serve/{out['engine'].cfg.name}")) \
        == _report_bytes(out["engine"].trace_report())
    assert _tokens(out["finished"]) == _tokens(jout["finished"])
    _same_windows(reg, jout["engine"].telemetry.registry)
    _same_timeline(tl, jout["timeline"])


# ------------------------------------------------------ flush edge cases
def _bare_rec(uid: int, mod=power):
    return mod.RetirementRecord(uid=uid, prompt_tokens=1, new_tokens=1,
                                decode_steps=1, sampled_steps=1, sites=())


def test_flush_is_idempotent():
    for tel, mod in ((TelemetryConfig, power),
                     (jtel.TelemetryConfig, jpower)):
        reg = (WindowedRegistry if mod is power
               else jtel.WindowedRegistry)(tel(window=3))
        fired = []
        reg.on_window.append(lambda w: fired.append(w.index))
        for i in range(4):
            reg.observe(_bare_rec(i, mod))
        first = reg.flush()
        assert [w.index for w in first] == [1] and fired == [0, 1]
        n_windows = len(reg.windows)
        assert reg.flush() == []
        assert fired == [0, 1] and len(reg.windows) == n_windows


def test_flush_sliding_tail_no_double_count():
    got = {}
    for tel, mod, reg_cls in ((TelemetryConfig, power, WindowedRegistry),
                              (jtel.TelemetryConfig, jpower,
                               jtel.WindowedRegistry)):
        reg = reg_cls(tel(window=4, stride=2))
        for i in range(5):
            reg.observe(_bare_rec(i, mod))
        closed = reg.flush()
        assert [(w.seqs, w.partial) for w in closed] == [([2, 3, 4], True)]
        partial_cover = [s for w in reg.windows if w.partial
                         for s in w.seqs]
        assert len(partial_cover) == len(set(partial_cover))
        assert {s for w in reg.windows for s in w.seqs} == set(range(5))
        got[mod] = [(w.index, w.seqs, w.closed, w.partial)
                    for w in reg.windows]
    assert got[power] == got[jpower]


# -------------------------------------------- finalize edge-case tracks
def test_finalize_zero_flip_oracle_equals_fixed(shift_records):
    records, mcfg = shift_records
    tl = _replay(records, mcfg, window=4, candidates=("proposed",))
    assert tl.n_flips == 0
    for w in tl.windows:
        assert w.energy["oracle"] == w.energy["proposed"]
        assert w.saving_oracle == w.saving_fixed
    sm = tl.summary()
    assert sm["saving_oracle"] == sm["saving_fixed"]
    _same_timeline(tl, _jreplay(records, window=4, candidates=("proposed",)),
                   exact=True)


def test_finalize_single_window_run(shift_records):
    records, mcfg = shift_records
    tl = _replay(records, mcfg, window=10 ** 6)
    assert len(tl.windows) == 1 and tl.windows[0].partial
    sm = tl.summary()
    for k in ("saving_fixed", "saving_online", "saving_oracle",
              "saving_actuated"):
        assert sm[k] == sm[k] and abs(sm[k]) < 1.0
    assert tl.windows[0].energy["oracle"] == tl.windows[0].energy["online"]
    _same_timeline(tl, _jreplay(records, window=10 ** 6), exact=True)


def test_finalize_empty_registry():
    telem = ServeTelemetry(TelemetryConfig(window=4),
                           scen.scenario_monitor())
    tl = telem.finalize()
    assert tl.windows == [] and tl.n_flips == 0
    sm = tl.summary()
    assert sm["n_windows"] == 0 and "saving_fixed" not in sm
    jsm = jtel.ServeTelemetry(jtel.TelemetryConfig(window=4),
                              _jax_mcfg()).finalize().summary()
    assert sm == jsm


# ------------------------------------------------- closed-loop actuation
@pytest.fixture(scope="module")
def actuated_pair():
    """The shift scenario with the loop closed (window=2: the flip
    commits mid-run), served by both packages."""
    jout, out = _pair("shift", window=2, actuate=True)
    assert _tokens(out["finished"]) == _tokens(jout["finished"])
    return jout, out


@pytest.fixture(scope="module")
def actuated_run(actuated_pair):
    return actuated_pair[1]


def test_actuated_swap_commits_mid_run(actuated_pair):
    jout, actuated_run = actuated_pair
    tl = actuated_run["timeline"]
    acc = actuated_run["engine"].accountant
    assert tl.n_swaps >= 1 and acc.swap_log
    last_window = tl.windows[-1].window
    for ev in tl.swaps:
        assert ev.epoch >= 1
        assert ev.window < last_window
        assert ev.delta_fj < 0
        assert set(ev.deltas) == set(ev.sites)
        for site, design in ev.sites.items():
            assert acc.design_for(site) == design != "proposed"
    assert acc.swap_log == jout["engine"].accountant.swap_log
    _same_windows(actuated_run["engine"].telemetry.registry,
                  jout["engine"].telemetry.registry)
    _same_timeline(tl, jout["timeline"])


def test_paged_engine_actuates_at_the_step_boundary():
    """The paged engine inherits the step loop, so the selector's flips
    are committed at its step boundary too: the shift scenario on the
    paged engine swaps as the JAX paged engine does, and its requests'
    actuated energies sum to the accountant's totals bit for bit."""
    from repro_torch.serve import PagedServeEngine
    assert PagedServeEngine.step is ServeEngine.step
    # the whole scenario: with 4 rows the quick one's flip comes only
    # with its last retirements, after which no step is left to commit it
    jout = jscen.run_scenario("shift", tcfg=jtel.TelemetryConfig(
        window=2, actuate=True), paged=True)
    out = scen.run_scenario(
        "shift", tcfg=TelemetryConfig(window=2, actuate=True),
        paged=True, device="cpu",
        params=_port_params(jout["engine"].params, "qwen1.5-0.5b"))
    eng = out["engine"]
    assert isinstance(eng, PagedServeEngine)
    assert _tokens(out["finished"]) == _tokens(jout["finished"])
    assert out["timeline"].n_swaps >= 1
    assert eng.accountant.swap_log == jout["engine"].accountant.swap_log
    _same_windows(eng.telemetry.registry, jout["engine"].telemetry.registry)
    _same_timeline(out["timeline"], jout["timeline"])
    totals = eng.accountant.actuated_totals()
    assert sum(r.power.energy["actuated"]["total"]
               for r in out["finished"]) == totals["total"]


def test_actuated_request_sum_bitexact(actuated_pair):
    jout, actuated_run = actuated_pair
    acc = actuated_run["engine"].accountant
    totals = acc.actuated_totals()
    finished = actuated_run["finished"]
    for comp in ("total", "streaming"):
        s = sum(r.power.energy["actuated"][comp] for r in finished)
        assert s == totals[comp]
    jtotals = jout["engine"].accountant.actuated_totals()
    assert totals.keys() == jtotals.keys()
    for c, v in jtotals.items():
        _close(totals[c], v, c)


def test_in_flight_swap_splits_epochs():
    """A request live across ``apply_swaps`` keeps its pre-swap
    recordings under the old design and prices later ones under the new,
    as the JAX accountant does on the same operands."""
    A = np.asarray(jax.random.normal(jax.random.key(0), (1, 32),
                                     jnp.float32))
    W = np.asarray(jax.random.normal(jax.random.key(1), (32, 48),
                                     jnp.float32))
    got = {}
    for name, acc, wrap in (
            ("port", power.PowerAccountant(scen.scenario_monitor()),
             torch.tensor),
            ("jax", jpower.PowerAccountant(jscen.scenario_monitor()),
             jnp.asarray)):
        acc.enable_actuation()
        retired = []
        acc.retire_hooks.append(retired.append)
        acc.begin(0, uid=7, prompt_tokens=0)
        acc.tick([0])
        acc.record_decode([0], wrap(A), wrap(W), "x")
        acc.mark_sampled([0])
        assert acc.apply_swaps({"decode/x": "baseline"}) == 1
        acc.tick([0])
        acc.record_decode([0], wrap(2.0 * A), wrap(W), "x")
        acc.mark_sampled([0])
        rep = acc.finish(0, new_tokens=2)
        (ret,) = retired
        (sr,) = ret.sites
        assert [d for d, _ in sr.epochs] == ["proposed", "baseline"]
        for k, v in sr.counters.items():
            if k != "zero_fraction":
                assert sum(c.get(k, 0.0)
                           for _, c in sr.epochs) == pytest.approx(v)
        mod = power if name == "port" else jpower
        e = mod.actuated_site_energy(sr, "proposed")
        assert rep.energy["actuated"]["total"] == e["total"]
        assert e["total"] != rep.energy["proposed"]["total"]
        assert e["total"] != rep.energy["baseline"]["total"]
        got[name] = (sr, e)
    (sr, e), (jsr, je) = got["port"], got["jax"]
    for (d, c), (jd, jc) in zip(sr.epochs, jsr.epochs):
        assert d == jd
        _same_counters({"x": c}, {"x": jc}, f"epoch {d}")
    for c, v in je.items():
        _close(e[c], v, c)


def test_actuated_trace_report_injection(actuated_pair):
    jout, actuated_run = actuated_pair
    eng = actuated_run["engine"]
    rep = eng.trace_report()
    assert "actuated" in rep.designs
    per_site: dict = {}
    for rec in eng.telemetry.registry.records:
        for sr in rec.sites:
            e = power.actuated_site_energy(sr, "proposed")
            per_site[sr.site] = per_site.get(sr.site, 0.0) + e["total"]
    for s in rep.sites:
        assert s.designs["actuated"]["total"] == per_site[s.name]
    act = sum(s.designs["actuated"]["total"] for s in rep.sites)
    fixed = sum(s.designs["proposed"]["total"] for s in rep.sites)
    assert act < fixed
    jrep = jout["engine"].trace_report()
    assert tuple(rep.designs) == tuple(jrep.designs)
    for s, t in zip(rep.sites, jrep.sites):
        assert s.name == t.name
        for c, v in t.designs["actuated"].items():
            _close(s.designs["actuated"][c], v, f"{s.name} {c}")


def test_actuated_replay_bitexact(actuated_pair, tmp_path):
    """The CLI replay of the dumped records reproduces the actuated track
    bit for bit, and so does the JAX CLI on the port's records."""
    jout, actuated_run = actuated_pair
    eng = actuated_run["engine"]
    rec_path = tmp_path / "act_records.json"
    eng.telemetry.registry.dump_records(str(rec_path))

    from repro.serve.telemetry.__main__ import main as jcli_main
    from repro_torch.serve.telemetry.__main__ import main as cli_main
    direct = actuated_run["timeline"].windows
    for i, cli in enumerate((cli_main, jcli_main)):
        out = tmp_path / f"act_timeline{i}.json"
        assert cli(["--replay", str(rec_path), "--window", "2",
                    "--json", str(out)]) == 0
        replayed = json.loads(out.read_text())["windows"]
        assert len(replayed) == len(direct)
        for got, want in zip(replayed, direct):
            assert got["energy"]["actuated"] == want.energy["actuated"]
            assert got["saving_actuated"] == want.saving_actuated


def test_actuated_vs_reported_differential(actuated_run):
    reg = actuated_run["engine"].telemetry.registry
    records, mcfg = reg.records, reg.mcfg
    on = _replay(records, mcfg, window=2, actuate=True)
    off = _replay(records, mcfg, window=2, actuate=False)
    assert [w.choices for w in on.windows] == \
        [w.choices for w in off.windows]
    assert [w.raw_choices for w in on.windows] == \
        [w.raw_choices for w in off.windows]
    assert [w.energy for w in on.windows] == \
        [w.energy for w in off.windows]
    _same_timeline(on, _jreplay(records, window=2, actuate=True),
                   exact=True)


def test_zero_swap_actuated_equals_fixed(shift_pair):
    jout, shift_run = shift_pair
    for w in shift_run["timeline"].windows:
        assert w.energy["actuated"] == w.energy["proposed"]
        assert w.saving_actuated == w.saving_fixed
    for w in jout["timeline"].windows:
        assert w.energy["actuated"] == w.energy["proposed"]


def test_apply_swaps_validation():
    for acc in (power.PowerAccountant(scen.scenario_monitor()),
                jpower.PowerAccountant(jscen.scenario_monitor())):
        with pytest.raises(RuntimeError, match="enable_actuation"):
            acc.apply_swaps({"decode/x": "baseline"})
        acc.enable_actuation()
        with pytest.raises(KeyError, match="unknown designs"):
            acc.apply_swaps({"decode/x": "nope"})
        assert acc.apply_swaps({}) == 0
        assert acc.apply_swaps({"decode/x": acc.mcfg.primary_design}) == 0
        assert acc.apply_swaps({"decode/x": "baseline"}) == 1
        assert acc.design_for("decode/x") == "baseline"
        assert acc.design_for("decode/y") == acc.mcfg.primary_design
        assert acc.swap_log == [(1, {"decode/x": "baseline"})]


def test_actuated_site_energy_epochs():
    """Epoch pricing, on a synthetic two-epoch record, equal to the JAX
    function's; the JSON round trip keeps the epochs and loads across
    packages."""
    pre = {"e/baseline/total": 10.0, "e/proposed/total": 6.0,
           "h/baseline": 4.0, "v/baseline": 4.0,
           "h/proposed": 3.0, "v/proposed": 2.0}
    post = {"e/baseline/total": 20.0, "e/proposed/total": 11.0,
            "h/baseline": 8.0, "v/baseline": 8.0,
            "h/proposed": 5.0, "v/proposed": 4.0}
    both = {k: pre[k] + post[k] for k in pre}
    rec = power.SiteRecord("decode/x", "dot_general", (1, 1, 4, 4), both,
                           epochs=(("proposed", pre), ("baseline", post)))
    e = power.actuated_site_energy(rec, "proposed")
    assert e["total"] == 6.0 + 20.0
    assert e["h"] == 3.0 + 8.0 and e["v"] == 2.0 + 8.0
    legacy = power.SiteRecord("decode/x", "dot_general", (1, 1, 4, 4), both)
    assert power.actuated_site_energy(legacy, "proposed")["total"] == \
        6.0 + 11.0
    again = power.SiteRecord.from_json_dict(rec.to_json_dict())
    assert again.epochs == rec.epochs
    jrec = jpower.SiteRecord.from_json_dict(rec.to_json_dict())
    assert jpower.actuated_site_energy(jrec, "proposed") == e
    assert jrec.to_json_dict() == rec.to_json_dict()


def test_scenario_registry_consistency():
    """Every scenario draws the JAX module's request stream (numpy, the
    same seeds) inside its arch's vocab, and the sparsified embedding
    rows are the JAX module's."""
    assert scen.SCENARIOS.keys() == jscen.SCENARIOS.keys()
    assert scen.SCENARIO_DESIGNS == jscen.SCENARIO_DESIGNS
    for name, sc in scen.SCENARIOS.items():
        jsc = jscen.SCENARIOS[name]
        assert (sc.arch, sc.sparse_band, sc.sparse_density, sc.window,
                sc.cache_len, sc.slots) == \
            (jsc.arch, jsc.sparse_band, jsc.sparse_density, jsc.window,
             jsc.cache_len, jsc.slots)
        vocab = SMOKES[sc.arch].vocab
        for quick in (True, False):
            for seed in (0, 3):
                reqs = scen.scenario_requests(sc, seed=seed, quick=quick)
                assert reqs == jscen.scenario_requests(jsc, seed=seed,
                                                       quick=quick)
        reqs = scen.scenario_requests(sc, quick=True)
        assert len(reqs) >= 2 * len(sc.phases)
        for _, prompt, max_new in reqs:
            assert max_new >= 1 and prompt
            assert all(0 <= t < vocab for t in prompt)
    jcfg = JSMOKES["qwen1.5-0.5b"].with_(compute_dtype="float32")
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    params = _port_params(jparams, "qwen1.5-0.5b")
    jscen.sparsify_embeddings(jparams, (0, 64), 0.9)
    scen.sparsify_embeddings(params, (0, 64), 0.9)
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np.asarray(jparams["embed"].value))


# ---------------------------------------------------- across packages
def test_records_replay_across_packages(shift_pair, tmp_path):
    """The port's records load in the JAX package and the JAX records in
    the port; each replays to bitwise the same timeline in both."""
    jout, out = shift_pair
    for name, reg in (("port", out["engine"].telemetry.registry),
                      ("jax", jout["engine"].telemetry.registry)):
        path = tmp_path / f"{name}.json"
        reg.dump_records(str(path))
        jmeta, jrecs = jtel.load_records(str(path))
        meta, recs = load_records(str(path))
        assert meta == jmeta
        assert [r.to_json_dict() for r in recs] == \
            [r.to_json_dict() for r in jrecs]
        mcfg = monitor.MonitorConfig(
            designs=scen.resolve_designs(meta["designs"]))
        for knobs in (dict(window=4), dict(window=2, hysteresis=0.001),
                      dict(window=3, stride=1)):
            _same_timeline(_replay(recs, mcfg, **knobs),
                           _jreplay(recs, **knobs), exact=True)
    # the two runs' records hold the same counters (energies 1e-6)
    _same_windows(out["engine"].telemetry.registry,
                  jout["engine"].telemetry.registry)


def test_both_clis_print_the_same_table(shift_pair, tmp_path, capsys):
    """One records file (either package's dump) through both CLIs: the
    same printed table, the same timeline JSON and CSV."""
    from repro.serve.telemetry.__main__ import main as jcli_main
    from repro_torch.serve.telemetry.__main__ import main as cli_main
    jout, out = shift_pair
    for name, reg in (("port", out["engine"].telemetry.registry),
                      ("jax", jout["engine"].telemetry.registry)):
        path = tmp_path / f"{name}.json"
        reg.dump_records(str(path))
        printed, files = [], []
        for i, cli in enumerate((cli_main, jcli_main)):
            js, cs = tmp_path / f"{name}{i}.json", tmp_path / f"{name}{i}.csv"
            assert cli(["--replay", str(path), "--window", "2",
                        "--hysteresis", "0.001", "--json", str(js),
                        "--csv", str(cs)]) == 0
            printed.append(capsys.readouterr().out.replace(str(js), "J")
                           .replace(str(cs), "C"))
            files.append((js.read_text(), cs.read_text()))
        assert printed[0] == printed[1]
        assert "windows" in printed[0] and "flips" in printed[0]
        assert files[0] == files[1]


# ----------------------------------------------------------- benchmark
def test_bench_serve_online_quick_artifact_passes_the_schema(tmp_path,
                                                            capsys):
    """``python -m repro_torch.bench.serve_online --quick --device cpu``:
    a row per scenario and the overhead row, flips found, the actuated
    track at or above the fixed one, and an artifact that validates
    against ``schemas/bench_online.schema.json``."""
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.bench import serve_online as bench
    root = Path(__file__).resolve().parents[1]
    path = tmp_path / "BENCH_online.json"
    bench.main(quick=True, emit_json=str(path), device="cpu")
    out = capsys.readouterr().out
    rows = [line.split(",")[0] for line in out.splitlines()
            if line.startswith("serve_online_")]
    assert rows == [f"serve_online_{n}" for n in sorted(scen.SCENARIOS)] \
        + ["serve_online_overhead"]
    payload = json.loads(path.read_text())
    assert payload["quick"] and payload["scenarios"] == sorted(
        scen.SCENARIOS)
    cells = payload["cells"]
    assert sum(cells[n]["n_flips"] for n in scen.SCENARIOS) > 0
    for n in scen.SCENARIOS:
        assert cells[n]["saving_actuated"] + 1e-12 >= \
            cells[n]["saving_fixed"]
    rc = subprocess.run(
        [sys.executable, str(root / "tools" / "check_bench_schema.py"),
         "--schema", str(root / "schemas" / "bench_online.schema.json"),
         str(path)], capture_output=True, text=True)
    assert rc.returncode == 0, rc.stdout + rc.stderr

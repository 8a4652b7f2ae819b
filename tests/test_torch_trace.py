"""The port's model-wide tracer against the JAX package's, live.

Each test runs the JAX tracer (``repro.trace``, its jaxpr interpreter on
the CPU, as ``tests/test_trace.py`` runs it) and the port's
(``repro_torch.trace``, run-time interception) on the same numpy inputs,
weights carried across by ``models.convert.params_from_jax``. The
tolerances:

* **Sites** -- names, kinds, shapes, ``calls`` and ``sampled_calls``:
  equal, in order (the smoke LM's 19 forward sites and its decode steps,
  ResNet50's 54 and MobileNetV1's 28 at 32 px).
* **Per-site counters on the same operands** (the port's capture fed the
  JAX tracer's recorded operands): every integer counter (``h/``, ``v/``,
  ``cycles``) bitwise, energies within rtol 1e-6 (float32 in another
  order).
* **The port's own forward.** Where its operands are bitwise the JAX
  forward's, energies within rtol 1e-6. The port computes bf16 SiLU and
  the weakly typed scalars as the JAX package does on the CPU
  (``repro_torch.models.layers.silu`` and ``weak``), so they are
  nearly everywhere:
  - the smoke LM's forward (bf16): every site within rtol 1e-6 (measured
    7.5e-8; two sites of layer 1 hold a word or two that a float32 exp
    an ulp apart moved), the whole trace's savings within 1e-6 absolute
    (1.5e-8);
  - its decode steps attend over the KV caches of the JAX package's
    jitted prefill, which XLA's fusions round apart from the traced
    forward, so from layer 1's attention on
    (:data:`LM_DECODE_FIRST_APART`) site energies hold within rtol 1e-2
    (measured on the CPU at most 9.3e-3), zero fractions within 2e-3
    (0), and the whole trace's savings within 1e-3 absolute (1.3e-5);
  - the smoke MoE (Phi-3.5-MoE, bf16): from the first expert down
    projection on (:data:`MOE_FIRST_APART`: one word of its operand in
    decode, of the combine's in the forward, a float32 exp an ulp
    apart), and in decode over the jitted prefill's caches from layer 1
    on, within the same tolerances (measured at most 7.5e-3 in decode,
    5.0e-5 in the forward; zero fractions 0; savings 2.9e-4);
  - the CNNs (float32): convolution and BN sums are taken in another
    order (``tests/test_torch_cnn.py``), so from the second site on the
    words differ in a few low bits; site energies within rtol 2e-2 and
    zero fractions within 1e-3 of the sampled words, whole-trace savings
    within 1e-3 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import trace as JT
from repro.apps.cnn import nets as JN
from repro.configs import SMOKES as JSMOKES
from repro.core import monitor as jmonitor
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.design import select as jselect
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.trace import interpret as JI
from repro.trace import sweep as jsweep
from repro.trace.capture import TraceCapture as JCapture
from repro.trace.report import build_report as jbuild_report
from repro_torch import design as D
from repro_torch import trace as T
from repro_torch.apps.cnn import nets
from repro_torch.configs import SMOKES
from repro_torch.core import monitor
from repro_torch.models import convert
from repro_torch.trace import interpret as I
from repro_torch.trace import sweep as sw
from repro_torch.trace.capture import CaptureConfig, TraceCapture
from repro_torch.trace.report import TraceReport, build_report

ARCH = "qwen1.5-0.5b"
RES = 32
RTOL = 1e-6
RNG = np.random.default_rng(0)

# generous caps: nothing in these tests is sub-sampled unless stated
BIG = CaptureConfig(
    monitor=monitor.MonitorConfig(max_rows=4096, max_cols=4096,
                                  max_depth=4096),
    max_batch=64, max_calls_per_site=64)
JBIG = JT.CaptureConfig(
    monitor=jmonitor.MonitorConfig(max_rows=4096, max_cols=4096,
                                   max_depth=4096),
    max_batch=64, max_calls_per_site=64)

#: the first site of the port's smoke-LM decode steps whose operands are
#: not the JAX tracer's bit for bit (layer 1 attends over the JAX jitted
#: prefill's caches), and the tolerances from there on (see the module
#: doc)
LM_DECODE_FIRST_APART = f"{ARCH}/scan[1]/b0/attn/bqkrd,bskd->bkrqs/dot#0"
LM_TOL = {"energy": 1e-2, "zero_fraction": 2e-3, "saving": 1e-3}
CNN_TOL = {"energy": 2e-2, "zero_fraction": 1e-3, "saving": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's port code: the suite runs
    several workers on the machine's cores, and a pool of threads in each
    ran the port's CPU traces many times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arr(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _t(a) -> torch.Tensor:
    """A JAX (or numpy) array as a tensor of the same dtype."""
    a = jnp.asarray(a)
    t = torch.from_numpy(np.array(a.astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


def _port_site(s) -> T.MatmulSite:
    return T.MatmulSite(s.name, s.kind, _t(s.lhs), _t(s.rhs))


def _jax_capture(sites, cfg=JT.DEFAULT_CAPTURE) -> JCapture:
    cap = JCapture(cfg)
    for s in sites:
        cap.record(s)
    return cap


def _port_capture(sites, cfg=T.CaptureConfig()) -> TraceCapture:
    cap = TraceCapture(cfg)
    for s in sites:
        cap.record(s)
    return cap


def _same_sites(got: TraceReport, want) -> None:
    assert ([(s.name, s.kind, tuple(s.shape), s.calls, s.sampled_calls)
             for s in got.sites]
            == [(s.name, s.kind, tuple(s.shape), s.calls, s.sampled_calls)
                for s in want.sites])


def _same_counters(got: TraceCapture, want: JCapture) -> None:
    """Integer counters bitwise, energies within RTOL, site by site."""
    assert list(got.sites) == list(want.sites)
    for name, w in want.sites.items():
        g = got.sites[name]
        assert set(g.counters) == set(w.counters), name
        for key, v in w.counters.items():
            if key.startswith(("h/", "v/", "cycles")):
                assert g.counters[key] == v, (name, key)
            else:
                np.testing.assert_allclose(g.counters[key], v, rtol=RTOL,
                                           err_msg=f"{name} {key}")
        np.testing.assert_allclose(g.zf_sum, w.zf_sum, rtol=RTOL,
                                   atol=1e-7, err_msg=name)


def _site_energies_close(got: TraceReport, want, tol: dict | None = None,
                         apart_from: str | None = None) -> None:
    """Per-site energies and zero fractions within RTOL; from the site
    ``apart_from`` on (the first whose operands the two forwards do not
    share bit for bit) within ``tol`` instead."""
    exact = True
    for g, w in zip(got.sites, want.sites):
        if g.name == apart_from:
            exact = False
        rtol = RTOL if exact else tol["energy"]
        for d in w.designs:
            for comp in ("total", "streaming"):
                np.testing.assert_allclose(
                    g.energy(d, comp), w.energy(d, comp), rtol=rtol,
                    err_msg=f"{g.name} {d} {comp}")
        np.testing.assert_allclose(
            g.zero_fraction, w.zero_fraction, rtol=RTOL,
            atol=1e-7 if exact else tol["zero_fraction"], err_msg=g.name)


def _savings_close(got: TraceReport, want, atol: float) -> None:
    g, w = got.summary(), want.summary()
    for key in ("total_saving", "streaming_saving", "streaming_share"):
        np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=atol,
                                   err_msg=key)
    assert 0.0 < g["streaming_saving"] < 1.0
    assert 0.0 < g["streaming_share"] < 1.0


# ------------------------------------------------------------- fixtures
def _jax_tree(params):
    return jax.tree.map(lambda p: np.asarray(p.value), params,
                        is_leaf=is_param)


@pytest.fixture(scope="module")
def lm_model():
    jcfg, cfg = JSMOKES[ARCH], SMOKES[ARCH]
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    return jcfg, jparams, cfg, convert.params_from_jax(_jax_tree(jparams),
                                                       cfg)


@pytest.fixture(scope="module")
def jax_forward(lm_model):
    """The JAX tracer's smoke-LM forward (``trace_arch``'s own steps, its
    sites kept): the sites and the report."""
    jcfg, jparams, _, _ = lm_model
    inputs = jsweep.model_inputs(jcfg, 2, 16, 0)
    sites = []
    JI.trace_fn(lambda p, b: jlm.logits_fn(p, jcfg,
                                           jlm.apply_model(p, jcfg, b)[0]),
                jparams, inputs, emit=sites.append, name=ARCH)
    return sites, jbuild_report(_jax_capture(sites), f"{ARCH}[forward]")


@pytest.fixture(scope="module")
def jax_decode(lm_model):
    """The JAX tracer's decode mode at seq 8, 3 steps (``trace_arch``'s
    own steps, its sites kept)."""
    jcfg, jparams, _, _ = lm_model
    seq, steps = 8, 3
    prefill = jax.jit(jlm.make_prefill_step(jcfg, cache_len=seq + steps))
    batch = jsweep.model_inputs(jcfg, 2, seq, 0)
    _, states = prefill(jparams, batch)
    decode = jlm.make_decode_step(jcfg)
    sites = []
    for t in range(steps):
        (_, states), _ = JI.trace_fn(decode, jparams, states,
                                     jsweep.decode_inputs(jcfg, 2, seq + t),
                                     emit=sites.append, name=ARCH)
    return sites, jbuild_report(_jax_capture(sites), f"{ARCH}[decode]")


@pytest.fixture(scope="module", params=["resnet50", "mobilenet"])
def jax_cnn(request):
    """The JAX tracer's CNN inference at 32 px (``trace_cnn``'s own
    steps, its sites kept) and the weights as the port's parameters."""
    net = request.param
    sites = []
    JI.trace_fn(JN.make_forward(net, seed=0),
                JN.synthetic_images(1, res=RES, seed=7),
                emit=sites.append, name=net)
    specs = JN.NETS[net]()
    params = nets.params_from_numpy(
        {k: np.asarray(v) for k, v in JN.init_weights(specs, 0).items()},
        {k: (np.asarray(g), np.asarray(b))
         for k, (g, b) in JN.init_bn(specs, 0).items()})
    return net, sites, jbuild_report(_jax_capture(sites),
                                     f"{net}[{RES}px]"), params


# ---------------------------------------------------------- interpreter
def test_outputs_match_jit():
    w1, w2, x = _arr(16, 32), _arr(32, 8), _arr(6, 16)
    jfn = lambda x: jax.nn.relu(x @ w1) @ w2                  # noqa: E731
    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)
    fn = lambda x: torch.relu(x @ tw1) @ tw2                  # noqa: E731
    out, skipped = T.trace_fn(fn, torch.from_numpy(x), emit=lambda s: None)
    assert skipped == [] and torch.equal(out, fn(torch.from_numpy(x)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(jfn)(x)),
                               rtol=1e-5, atol=1e-5)


def test_finds_every_dot_with_operands():
    w1, w2, x = _arr(16, 32), _arr(32, 8), _arr(6, 16)
    jsites, sites = [], []
    JI.trace_fn(lambda x: jax.nn.relu(x @ w1) @ w2, x, emit=jsites.append,
                name="f")
    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)
    T.trace_fn(lambda x: torch.relu(x @ tw1) @ tw2, torch.from_numpy(x),
               emit=sites.append, name="f")
    assert [s.name for s in sites] == [s.name for s in jsites] == [
        "f/dot#0", "f/dot#1"]
    for s, js in zip(sites, jsites):
        assert s.kind == js.kind and s.shape == js.shape
        np.testing.assert_allclose(s.lhs.numpy(), np.asarray(js.lhs),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(s.rhs.numpy(), np.asarray(js.rhs))
    np.testing.assert_array_equal(sites[0].lhs[0].numpy(), x)


def test_scan_is_unrolled_per_iteration():
    """The JAX tracer names each iteration of a ``lax.scan``; the port's
    loops name theirs with ``scope("scan[i]")`` (as the layer stack and
    the prefill attention do), giving the same names and operands."""
    ws, x = _arr(3, 8, 8), _arr(4, 8)

    def jfn(x):
        def body(c, w):
            return jnp.tanh(c @ w), ()
        return jax.lax.scan(body, x, ws)[0]

    def fn(x):
        for i, w in enumerate(torch.from_numpy(ws)):
            with I.scope(f"scan[{i}]"):
                x = torch.tanh(x @ w)
        return x

    jsites, sites = [], []
    JI.trace_fn(jfn, x, emit=jsites.append)
    T.trace_fn(fn, torch.from_numpy(x), emit=sites.append)
    assert [s.name for s in sites] == [s.name for s in jsites]
    assert len({s.name for s in sites}) == 3
    for i, s in enumerate(sites):
        np.testing.assert_array_equal(s.rhs[0].numpy(), ws[i])
    assert I.scope("x") is I.scope("y")      # a shared no-op untraced


def test_batched_dot_general_shapes():
    a, b = _arr(5, 7, 4), _arr(5, 4, 3)
    dims = (((2,), (1,)), ((0,), (0,)))
    A, W = I.dot_operands_3d(torch.from_numpy(a), torch.from_numpy(b), dims)
    JA, JW = JI.dot_operands_3d(a, b, dims)
    np.testing.assert_array_equal(A.numpy(), np.asarray(JA))
    np.testing.assert_array_equal(W.numpy(), np.asarray(JW))


@pytest.mark.parametrize("spec,xs,ys", [
    ("bqkrd,bskd->bkrqs", (2, 5, 3, 2, 4), (2, 6, 3, 4)),   # prefill
    ("bkrqs,bskd->bkrqd", (2, 3, 2, 5, 6), (2, 6, 3, 4)),
    ("bqkrd,bskd->bkrqs", (2, 1, 3, 1, 4), (2, 6, 3, 4)),   # decode
    ("bkrqs,bskd->bqkrd", (2, 3, 1, 1, 6), (2, 6, 3, 4)),
    ("bqkrd,bskd->bkrqs", (1, 1, 3, 2, 4), (1, 6, 3, 4))])
def test_einsum_operands_are_jax_dot_general_operands(spec, xs, ys):
    """The attention einsums' sites, in the element order of the
    ``dot_general`` ``jnp.einsum`` binds (which operand is its left side
    depends on the output order; unit dims are dropped where the other
    side's are not)."""
    _einsum_case(spec, _arr(*xs), _arr(*ys))


@pytest.mark.parametrize("spec,xs,ys", [
    ("gsec,gsd->gecd", (2, 6, 4, 3), (2, 6, 5)),
    ("gecd,edf->gecf", (2, 4, 3, 5), (4, 5, 7)),
    ("gecf,efd->gecd", (2, 4, 3, 7), (4, 7, 5)),
    ("gsec,gecd->gsd", (2, 6, 4, 3), (2, 4, 3, 5)),
    ("gsec,gsd->gecd", (3, 1, 4, 1), (3, 1, 5)),       # decode
    ("gecd,edf->gecf", (3, 4, 1, 5), (4, 5, 7)),
    ("gecf,efd->gecd", (1, 4, 1, 7), (4, 7, 5)),
    ("gsec,gecd->gsd", (3, 1, 4, 1), (3, 4, 1, 5)),
    ("gsec,gecd->gsd", (1, 1, 4, 1), (1, 4, 1, 5))])
def test_moe_einsum_operands_are_jax_dot_general_operands(spec, xs, ys):
    """The MoE's five einsums (``e`` a batch dim of the expert products
    only; ``(c, e)`` contracted together in the combine), in a prefill
    and in decode (S = 1, capacity 1, one group a row; and one row). Draws
    from their own generator, so the module's shared one gives the other
    tests the draws they had."""
    rng = np.random.default_rng(len(xs) * 10 + len(ys))
    _einsum_case(spec, rng.standard_normal(xs).astype(np.float32),
                 rng.standard_normal(ys).astype(np.float32))


def _einsum_case(spec, x, y):
    jsites, sites = [], []
    JI.trace_fn(lambda x, y: jnp.einsum(spec, x, y), x, y,
                emit=jsites.append)
    out, _ = T.trace_fn(lambda x, y: I.einsum(spec, x, y),
                        torch.from_numpy(x), torch.from_numpy(y),
                        emit=sites.append)
    (js,), (s,) = jsites, sites
    assert s.name == js.name == f"{spec}/dot#0"
    np.testing.assert_array_equal(s.lhs.numpy(), np.asarray(js.lhs))
    np.testing.assert_array_equal(s.rhs.numpy(), np.asarray(js.rhs))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jnp.einsum(spec, x, y)), rtol=1e-5, atol=1e-6)


def _conv_case(groups: int):
    c = 6 if groups > 1 else 5
    x, w = _arr(2 if groups == 1 else 1, 8, 8, c), _arr(
        3, 3, 1 if groups > 1 else c, c if groups > 1 else 7)

    def jfn(x):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups)

    def fn(x):      # PyTorch's layouts, SAME as symmetric padding 1
        y = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1),
            padding=1, groups=groups)
        return y.permute(0, 2, 3, 1)

    jsites, sites = [], []
    jout, _ = JI.trace_fn(jfn, x, emit=jsites.append)
    out, _ = T.trace_fn(fn, torch.from_numpy(x), emit=sites.append)
    (js,), (s,) = jsites, sites
    assert (s.name, s.kind, s.shape) == (js.name, js.kind, js.shape)
    np.testing.assert_array_equal(s.lhs.numpy(), np.asarray(js.lhs))
    np.testing.assert_array_equal(s.rhs.numpy(), np.asarray(js.rhs))
    return s, out, jout


def test_conv_lowering_reproduces_conv():
    site, out, jout = _conv_case(groups=1)
    assert site.kind == "conv"
    y = (site.lhs[0] @ site.rhs[0]).reshape(out.shape)
    np.testing.assert_allclose(y.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)


def test_depthwise_conv_lowering():
    site, out, jout = _conv_case(groups=6)
    assert site.kind == "dwconv" and site.shape == (6, 64, 9, 1)
    y = torch.einsum("gmk,gkn->gmn", site.lhs, site.rhs)[..., 0]
    np.testing.assert_allclose(y.T.reshape(out.shape).numpy(),
                               np.asarray(jout), rtol=1e-4, atol=1e-4)


# --------------------------------------------- counters vs hand-wired
def test_traced_counters_match_direct_stream_report():
    w1, w2, x = _arr(16, 32), _arr(32, 8), _arr(6, 16)
    jrep = JT.trace_model(lambda x: jax.nn.relu(x @ w1) @ w2, x,
                          name="two_matmul", cfg=JBIG)
    tw1, tw2 = torch.from_numpy(w1), torch.from_numpy(w2)
    rep = T.trace_model(lambda x: torch.relu(x @ tw1) @ tw2,
                        torch.from_numpy(x), name="two_matmul", cfg=BIG)
    _same_sites(rep, jrep)
    _site_energies_close(rep, jrep)
    _savings_close(rep, jrep, atol=0.0)


def test_call_accumulation_and_extrapolation():
    w = _arr(8, 8)
    xs = [(_arr(4, 8),) for _ in range(5)]
    cfg = CaptureConfig(monitor=BIG.monitor, max_batch=64,
                        max_calls_per_site=2)
    jcfg = JT.CaptureConfig(monitor=JBIG.monitor, max_batch=64,
                            max_calls_per_site=2)
    tw = torch.from_numpy(w)
    rep = T.trace_calls(lambda x: x @ tw,
                        [(torch.from_numpy(x),) for x, in xs], name="rep",
                        cfg=cfg)
    jrep = JT.trace_calls(lambda x: x @ w, xs, name="rep", cfg=jcfg)
    _same_sites(rep, jrep)
    (site,) = rep.sites
    assert (site.calls, site.sampled_calls) == (5, 2)
    _site_energies_close(rep, jrep)


# ------------------------------------------------------------ LM tracing
def test_lm_smoke_trace_site_count_and_names(lm_model, jax_forward):
    _, _, _, params = lm_model
    jsites, jrep = jax_forward
    rep = T.trace_arch(ARCH, "forward", batch=2, seq=16, device="cpu",
                       params=params)
    assert len(rep.sites) == 19
    _same_sites(rep, jrep)
    names = " ".join(s.name for s in rep.sites)
    for frag in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp",
                 "scan[0]", "scan[1]", "lm_head"):
        assert frag in names, frag
    _site_energies_close(rep, jrep)
    # savings are 1 - a ratio of energies within rtol 1e-6: 1e-6 absolute
    _savings_close(rep, jrep, atol=RTOL)
    # on the JAX tracer's own operands: every counter of every site
    _same_counters(_port_capture(map(_port_site, jsites)),
                   _jax_capture(jsites))


def test_lm_decode_trace_accumulates_sites(lm_model, jax_decode):
    _, _, _, params = lm_model
    jsites, jrep = jax_decode
    rep = T.trace_arch(ARCH, "decode", batch=2, seq=8, decode_steps=3,
                       device="cpu", params=params)
    _same_sites(rep, jrep)
    assert all(s.calls == 3 for s in rep.sites)
    assert any("lm_head" in s.name for s in rep.sites)
    _site_energies_close(rep, jrep, LM_TOL,
                         apart_from=LM_DECODE_FIRST_APART)
    _savings_close(rep, jrep, LM_TOL["saving"])
    _same_counters(_port_capture(map(_port_site, jsites)),
                   _jax_capture(jsites))


def test_cnn_traces_at_32px(jax_cnn):
    """ResNet50 (54 sites: 53 convs and the fc) and MobileNetV1 (28, its
    13 depthwise convs as ``"dwconv"``) at 32 px: the JAX tracer's sites,
    its counters on its operands, its energies within CNN_TOL."""
    net, jsites, jrep, params = jax_cnn
    rep = T.trace_cnn(net, res=RES, device="cpu", params=params)
    _same_sites(rep, jrep)
    kinds = [s.kind for s in rep.sites]
    assert len(kinds) == {"resnet50": 54, "mobilenet": 28}[net]
    assert kinds[-1] == "dot_general"
    assert kinds.count("dwconv") == {"resnet50": 0, "mobilenet": 13}[net]
    _site_energies_close(rep, jrep, CNN_TOL, apart_from=rep.sites[1].name)
    _savings_close(rep, jrep, CNN_TOL["saving"])
    _same_counters(_port_capture(map(_port_site, jsites)),
                   _jax_capture(jsites))


MOE = "phi3.5-moe-42b-a6.6b"
#: the first site of the port's own Phi-3.5-MoE smoke forward (and of
#: each decode step) from which its operands may part from the JAX
#: tracer's: the first expert down projection (see the module doc)
MOE_FIRST_APART = f"{MOE}/scan[0]/b0/moe/gecf,efd->gecd/dot#0"


class _Recording(TraceCapture):
    """A capture that keeps every site it records."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.recorded = []

    def record(self, site):
        self.recorded.append(site)
        super().record(site)


@pytest.fixture(scope="module")
def moe_model():
    jcfg, cfg = JSMOKES[MOE], SMOKES[MOE]
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    return jcfg, jparams, cfg, convert.params_from_jax(_jax_tree(jparams),
                                                       cfg)


def _jax_moe_sites(jcfg, jparams, mode: str) -> list:
    """The JAX tracer's sites of ``trace_arch``'s own steps: the forward
    at batch 2, seq 16, or 3 decode steps after a prefill of seq 8."""
    sites = []
    if mode == "forward":
        JI.trace_fn(lambda p, b: jlm.logits_fn(
            p, jcfg, jlm.apply_model(p, jcfg, b)[0]), jparams,
            jsweep.model_inputs(jcfg, 2, 16, 0), emit=sites.append,
            name=MOE)
        return sites
    seq, steps = 8, 3
    prefill = jax.jit(jlm.make_prefill_step(jcfg, cache_len=seq + steps))
    _, states = prefill(jparams, jsweep.model_inputs(jcfg, 2, seq, 0))
    decode = jlm.make_decode_step(jcfg)
    for t in range(steps):
        (_, states), _ = JI.trace_fn(decode, jparams, states,
                                     jsweep.decode_inputs(jcfg, 2, seq + t),
                                     emit=sites.append, name=MOE)
    return sites


@pytest.mark.parametrize("mode", ["forward", "decode"])
def test_moe_smoke_trace_sites_equal_jax(moe_model, mode):
    """Phi-3.5-MoE's smoke forward (2 layers of attention's six sites,
    the float32 router and the five MoE einsums, then the head: 25 sites)
    and 3 decode steps (capacity 1, one group a row): the JAX tracer's
    sites -- names, kinds, shapes, calls and operand dtypes, in order --,
    the operands bitwise up to :data:`MOE_FIRST_APART` in each step,
    energies within LM_TOL from there on, and on the JAX tracer's own
    operands every counter of every site."""
    jcfg, jparams, _, params = moe_model
    jsites = _jax_moe_sites(jcfg, jparams, mode)
    jrep = jbuild_report(_jax_capture(jsites), f"{MOE}[{mode}]")
    cap = _Recording(sw.make_capture_config())
    if mode == "forward":
        rep = T.trace_arch(MOE, "forward", batch=2, seq=16, device="cpu",
                           params=params, capture=cap)
    else:
        rep = T.trace_arch(MOE, "decode", batch=2, seq=8, decode_steps=3,
                           device="cpu", params=params, capture=cap)
    _same_sites(rep, jrep)
    assert len(rep.sites) == 25
    names = [s.name for s in rep.sites]
    assert sum("/moe/" in n for n in names) == 12
    assert all(s.calls == (1 if mode == "forward" else 3)
               for s in rep.sites)
    apart = names.index(MOE_FIRST_APART)
    assert len(cap.recorded) == len(jsites)
    for i, (s, js) in enumerate(zip(cap.recorded, jsites)):
        assert (s.name, s.kind, s.shape) == (js.name, js.kind, js.shape)
        assert str(s.lhs.dtype) == f"torch.{js.lhs.dtype}"
        if i % len(names) < apart:
            np.testing.assert_array_equal(_t(js.lhs).float().numpy(),
                                          s.lhs.float().numpy(), s.name)
            np.testing.assert_array_equal(_t(js.rhs).float().numpy(),
                                          s.rhs.float().numpy(), s.name)
    _site_energies_close(rep, jrep, LM_TOL, apart_from=MOE_FIRST_APART)
    _savings_close(rep, jrep, LM_TOL["saving"])
    _same_counters(_port_capture(map(_port_site, jsites)),
                   _jax_capture(jsites))


# ---------------------------------------------------------- serialization
def _small_reports():
    w, x = _arr(8, 12), _arr(4, 8)
    rep = T.trace_model(lambda x: x @ torch.from_numpy(w),
                        torch.from_numpy(x), name="rt", cfg=BIG)
    return rep, JT.trace_model(lambda x: x @ w, x, name="rt", cfg=JBIG)


def test_json_roundtrip(tmp_path):
    rep, jrep = _small_reports()
    path = str(tmp_path / "rep.json")
    rep.to_json(path)
    back = TraceReport.from_json(path)
    assert (back.model, back.geometry) == (rep.model, rep.geometry)
    _same_sites(back, jrep)
    for k, v in jrep.summary().items():
        got = back.summary()[k]
        if isinstance(v, float):
            np.testing.assert_allclose(got, v, rtol=RTOL)
        elif k != "design_savings":
            assert got == v, k


def test_csv_export(tmp_path):
    rep, jrep = _small_reports()
    rep.to_csv(str(tmp_path / "rep.csv"))
    jrep.to_csv(str(tmp_path / "jrep.csv"))
    lines = open(tmp_path / "rep.csv").read().strip().splitlines()
    jlines = open(tmp_path / "jrep.csv").read().strip().splitlines()
    assert len(lines) == len(jlines) == 2 and lines[0] == jlines[0]
    assert lines[0].startswith("name,kind")


def test_table_matches_jax_layout():
    rep, jrep = _small_reports()
    got, want = rep.table().splitlines(), jrep.table().splitlines()
    assert len(got) == len(want) and got[:2] == want[:2]
    assert got[2].split()[:4] == want[2].split()[:4]


# -------------------------------------------------------- monitor sampling
def test_subsample_covers_tail():
    x = np.ones((1000, 16), np.float32)
    x[768:] = 0.0
    w = _arr(16, 4)
    m = monitor.monitor_matmul(torch.from_numpy(x), torch.from_numpy(w))
    jm = jmonitor.monitor_matmul(jnp.asarray(x), jnp.asarray(w))
    assert float(m["zero_fraction"]) == pytest.approx(232 / 1000, abs=0.02)
    for k, v in jm.items():     # savings are 1 - a ratio of energies
        np.testing.assert_allclose(float(m[k]), float(v), rtol=RTOL,
                                   atol=2 * RTOL, err_msg=k)


def test_monitor_matmul_reports_sample_sizes():
    a, w = _arr(10, 2000), _arr(2000, 300)
    m = monitor.monitor_matmul(torch.from_numpy(a), torch.from_numpy(w))
    jm = jmonitor.monitor_matmul(jnp.asarray(a), jnp.asarray(w))
    for k in monitor.SIZE_KEYS:
        assert float(m[k]) == float(jm[k]), k
    assert (float(m["sample_k"]), float(m["sample_n"])) == (1024, 256)


# ---------------------------------------------------------- ported pieces
def test_model_inputs_are_the_synthetic_lm_batch():
    jcfg, cfg = JSMOKES[ARCH], SMOKES[ARCH]
    for batch, seq, seed in ((2, 16, 0), (3, 9, 5)):
        want = SyntheticLM(jcfg, DataConfig(seq_len=seq, global_batch=batch,
                                            seed=seed)).batch(0)["tokens"]
        got = sw.model_inputs(cfg, batch, seq, seed)["tokens"]
        np.testing.assert_array_equal(got.numpy(), want)
        for pos in (8, 10):
            jd = jsweep.decode_inputs(jcfg, batch, pos, seed)
            d = sw.decode_inputs(cfg, batch, pos, seed)
            np.testing.assert_array_equal(d["tokens"].numpy(),
                                          np.asarray(jd["tokens"]))
            np.testing.assert_array_equal(d["positions"].numpy(),
                                          np.asarray(jd["positions"]))


def test_select_counters_and_apply_selection_equal_jax(lm_model,
                                                       jax_forward):
    """Per-site selection over the named menu on the JAX tracer's
    operands: the same choices from flat counters and from the report,
    savings within RTOL, and the ``selected`` pseudo-design injected."""
    jsites, _ = jax_forward
    menu = tuple(D.named_designs())
    cfg = sw.make_capture_config(designs=menu)
    jcfg = jsweep.make_capture_config(designs=menu)
    cap = _port_capture(map(_port_site, jsites), cfg)
    jcap = _jax_capture(jsites, jcfg)
    sel = D.select_counters({n: s.counters for n, s in cap.sites.items()})
    jsel = jselect.select_counters({n: s.counters
                                    for n, s in jcap.sites.items()})
    assert sel.choices == jsel.choices and sel.changed == jsel.changed
    rep, jrep = build_report(cap, "m"), jbuild_report(jcap, "m")
    got, want = D.apply_selection(rep), jselect.apply_selection(jrep)
    assert got.choices == want.choices == sel.choices
    for a, b in ((got, want), (sel, jsel)):     # 1 - a ratio of energies
        np.testing.assert_allclose(a.saving_total, b.saving_total,
                                   rtol=RTOL, atol=2 * RTOL)
    assert rep.designs[-1] == "selected" == jrep.designs[-1]
    assert [s.selected for s in rep.sites] == [s.selected
                                              for s in jrep.sites]


def test_monitor_streams_and_summarize_equal_jax():
    a, w = _arr(40, 48), _arr(48, 24)
    a[a < 0] = 0.0
    got = monitor.monitor_streams(torch.from_numpy(a), torch.from_numpy(w))
    want = jmonitor.monitor_streams(jnp.asarray(a), jnp.asarray(w))
    for k, v in want["report"].items():
        np.testing.assert_allclose(float(got["report"][k]), float(v),
                                   rtol=RTOL, err_msg=k)
    for d in ("baseline", "proposed"):
        for k, v in want["power"][d].items():
            np.testing.assert_allclose(float(got["power"][d][k]), float(v),
                                       rtol=RTOL, err_msg=f"{d} {k}")
    with pytest.raises(ValueError, match="legacy twin-design"):
        monitor.monitor_streams(torch.from_numpy(a), torch.from_numpy(w),
                                monitor.MonitorConfig(designs=tuple(
                                    D.named_designs().values())))
    layers = {f"l{i}": (a * (i + 1), w) for i in range(3)}
    got = monitor.summarize({k: monitor.monitor_matmul(
        torch.from_numpy(x), torch.from_numpy(y))
        for k, (x, y) in layers.items()})
    want = jmonitor.summarize({k: jmonitor.monitor_matmul(
        jnp.asarray(x), jnp.asarray(y)) for k, (x, y) in layers.items()})
    assert set(got) == set(want) and "power/full_m_mean" not in got
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL,
                                   err_msg=k)
    assert monitor.summarize({}) == {}


@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_no_site_is_counted_twice_under_a_seam(lm_model, jax_decode,
                                               backend):
    """A decode step's matmuls run through the gated matmul's plain
    version (``x @ w`` inside the seam): each is one site, once a step,
    whichever backend; and the untraced step launches no hook."""
    _, _, _, params = lm_model
    jsites, _ = jax_decode
    rep = T.trace_arch(ARCH, "decode", batch=2, seq=8, decode_steps=2,
                       device="cpu", params=params, backend=backend)
    assert [s.name for s in rep.sites] == list(dict.fromkeys(
        s.name for s in jsites))
    assert all(s.calls == 2 for s in rep.sites)
    assert not I.active()


def test_unknown_and_pending_archs_name_the_roadmap():
    """No arch of the zoo is pending any more: an unknown name raises
    KeyError listing the archs."""
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        T.trace_arch("no-such-arch", device="cpu")
    with pytest.raises(ValueError, match="unknown trace mode"):
        T.trace_arch(ARCH, "train", device="cpu", seq=4)
    if not torch.cuda.is_available():     # the card is the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.trace_cnn("mobilenet", res=32)

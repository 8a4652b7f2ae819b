"""The model-wide tracer on the rest of the LM zoo against the JAX
package's, live: MLA (DeepSeek-V2-Lite, MiniCPM3-4B), the M-RoPE VLM
(Qwen2-VL-72B) and codes audio (MusicGen-medium) backbones here, the
recurrent and xLSTM archs in ``tests/test_torch_zoo_trace_recurrent.py``.

For each smoke arch, the forward at batch 2, seq 16 and one decode step
after a prefill of seq 8 (``trace_arch``'s own steps), on the same
weights (``models.convert``):

* the sites -- names, kinds, shapes, operand dtypes, in order -- equal
  the JAX tracer's: the ``scan[i]`` frames of the chunk and step loops,
  MLA's seven einsums, the local attention's, the decode convolution's
  ``bwd,wd->bd`` (``d`` a batch dim), the codes head's ``...d,kdv->...kv``;
* on the JAX tracer's own operands, every counter of every site: integer
  counters bitwise, energies within rtol 1e-6;
* on the port's own operands, the whole trace's savings within 1e-3
  absolute of the JAX tracer's: the forwards round bf16 apart in a few
  words, and the decode attends over the JAX jitted prefill's states, so
  single sites part further (a MusicGen decode site's energy by 1.7%) and
  are not held one by one.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import SMOKES as JSMOKES
from repro.models import lm as jlm
from repro.models.layers import is_param
from repro.trace import interpret as JI
from repro.trace import sweep as jsweep
from repro.trace.report import build_report as jbuild_report
from repro_torch import trace as T
from repro_torch.configs import SMOKES
from repro_torch.models import convert
from repro_torch.trace import sweep as sw
from repro_torch.trace.capture import TraceCapture
from test_torch_trace import (LM_TOL, _jax_capture, _port_capture,
                              _port_site, _same_counters, _same_sites,
                              _savings_close)

ARCHS = ("deepseek-v2-lite-16b", "minicpm3-4b", "qwen2-vl-72b",
         "musicgen-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Recording(TraceCapture):
    """A capture that keeps every site it records."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.recorded = []

    def record(self, site):
        self.recorded.append(site)
        super().record(site)


def jax_sites(arch: str, jcfg, jparams, mode: str) -> list:
    """The JAX tracer's sites of ``trace_arch``'s own steps."""
    sites = []
    if mode == "forward":
        batch = jsweep.model_inputs(jcfg, 2, 16, 0)
        batch.pop("labels", None)
        JI.trace_fn(lambda p, b: jlm.logits_fn(
            p, jcfg, jlm.apply_model(p, jcfg, b)[0]), jparams, batch,
            emit=sites.append, name=arch)
        return sites
    seq = 8
    batch = jsweep.model_inputs(jcfg, 2, seq, 0)
    batch.pop("labels", None)
    _, states = jax.jit(jlm.make_prefill_step(jcfg, seq + 1))(jparams, batch)
    JI.trace_fn(jlm.make_decode_step(jcfg), jparams, states,
                jsweep.decode_inputs(jcfg, 2, seq), emit=sites.append,
                name=arch)
    return sites


def check_arch_trace(arch: str) -> None:
    jcfg, cfg = JSMOKES[arch], SMOKES[arch]
    jparams = jlm.init_model(jax.random.key(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(
        lambda p: np.asarray(p.value), jparams, is_leaf=is_param), cfg)
    for mode in ("forward", "decode"):
        jsites = jax_sites(arch, jcfg, jparams, mode)
        jrep = jbuild_report(_jax_capture(jsites), f"{arch}[{mode}]")
        cap = _Recording(sw.make_capture_config())
        if mode == "forward":
            rep = T.trace_arch(arch, "forward", batch=2, seq=16,
                               device="cpu", params=params, capture=cap)
        else:
            rep = T.trace_arch(arch, "decode", batch=2, seq=8,
                               decode_steps=1, device="cpu", params=params,
                               capture=cap)
        _same_sites(rep, jrep)
        assert [(s.name, s.kind, s.shape, str(s.lhs.dtype), str(s.rhs.dtype))
                for s in cap.recorded] == [
            (s.name, s.kind, s.shape, f"torch.{s.lhs.dtype}",
             f"torch.{s.rhs.dtype}") for s in jsites], (arch, mode)
        _savings_close(rep, jrep, LM_TOL["saving"])
        _same_counters(_port_capture(map(_port_site, jsites)),
                       _jax_capture(jsites))


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_trace_sites_equal_jax(arch):
    check_arch_trace(arch)

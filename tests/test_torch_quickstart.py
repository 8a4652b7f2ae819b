"""The quickstart slice as a whole: ``repro_torch.apps.quickstart`` on the
CPU against the JAX package's own functions on the example's arrays, and
its CLI against ``examples/quickstart.py`` line for line.

Integers (the weight bus's toggles, the gated-tile map) must be equal;
energies and savings agree within rtol 1e-6 (float32 in both packages,
the same operation order); the gated matmul's max-err figure is the one
number that may differ, by the product's stated tolerance
(``TILED_TOL``) on each side.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import design as j_design
from repro.core import power as j_power
from repro.core import systolic as j_systolic
from repro.core.bits import to_bits as j_to_bits
from repro.kernels import bic_encode as j_bic_encode
from repro.kernels import count_transitions as j_count_transitions
from repro.kernels import zvg_matmul as j_zvg_matmul
from repro_torch.apps import quickstart
from repro_torch.kernels.zvg_matmul.cases import TILED_TOL

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-6


@pytest.fixture(scope="module")
def both():
    """The example's computation through the JAX package (as
    ``examples/quickstart.py`` runs it) and through the port on the CPU."""
    A, W = quickstart.operands()
    jA, jW = jnp.asarray(A), jnp.asarray(W)
    report = j_systolic.sa_stream_report(jA, jW)
    bits = j_to_bits(jnp.asarray(W, jnp.bfloat16))
    tx, inv = j_bic_encode(bits)
    inv_i = inv.astype(jnp.int32)
    out, gated = j_zvg_matmul(jnp.asarray(A, jnp.bfloat16),
                              jnp.asarray(W, jnp.bfloat16))
    ev = j_design.evaluate_operands(
        jA, jW, tuple(j_design.named_designs().values()))
    jax_side = {
        "report": report, "power": j_power.sa_power(report),
        "t_raw": int(j_count_transitions(bits).sum()),
        "t_enc": int(j_count_transitions(tx).sum())
        + int(jnp.abs(inv_i[1:] ^ inv_i[:-1]).sum()),
        "out": np.array(out), "gated": np.asarray(gated),
        "max_err": float(jnp.abs(out - jA @ jW).max()),
        "evaluated": ev, "savings": j_design.savings(ev),
        "best": min((n for n in ev if n != "baseline"),
                    key=lambda n: float(ev[n]["energy"]["total"])),
    }
    return quickstart.run(device="cpu"), jax_side


def test_operands_are_the_example_s(both):
    A, W = quickstart.operands()
    assert A.shape == (128, 512) and W.shape == (512, 128)
    assert 0.5 < float((A == 0).mean()) < 0.6


def test_integers_equal(both):
    got, want = both
    assert got["t_raw"] == want["t_raw"] == 353835
    assert got["t_enc"] == want["t_enc"] == 315903
    np.testing.assert_array_equal(got["gated"].numpy(), want["gated"])
    assert got["best"] == want["best"] == "bic-west"


def test_report_and_power_within_rtol(both):
    got, want = both
    assert set(got["report"]) == set(want["report"])
    for k, v in want["report"].items():
        np.testing.assert_allclose(float(got["report"][k]), float(v),
                                   rtol=RTOL, err_msg=k)
    for design in ("baseline", "proposed"):
        for k, v in want["power"][design].items():
            np.testing.assert_allclose(float(got["power"][design][k]),
                                       float(v), rtol=RTOL,
                                       err_msg=f"{design}/{k}")
    for k in ("saving_total", "saving_streaming", "streaming_share_base"):
        np.testing.assert_allclose(float(got["power"][k]),
                                   float(want["power"][k]), rtol=RTOL)


def test_design_menu_within_rtol(both):
    got, want = both
    assert set(got["evaluated"]) == set(want["evaluated"])
    for name, r in want["evaluated"].items():
        for comp, v in r["energy"].items():
            np.testing.assert_allclose(
                float(got["evaluated"][name]["energy"][comp]), float(v),
                rtol=RTOL, err_msg=f"{name}/{comp}")
        for k, v in want["savings"][name].items():
            np.testing.assert_allclose(float(got["savings"][name][k]),
                                       float(v), rtol=RTOL, atol=1e-7,
                                       err_msg=f"{name}/{k}")


def test_gated_product_within_tolerance(both):
    got, want = both
    scale = float(np.abs(want["out"]).max())
    diff = float((got["out"] - torch.from_numpy(want["out"])).abs().max())
    assert diff <= TILED_TOL[torch.bfloat16] * scale
    # the max-err figure moves by at most the products' difference plus
    # the float32 reference's own order of sums
    assert abs(got["max_err"] - want["max_err"]) <= \
        2 * TILED_TOL[torch.bfloat16] * scale


def _run(args, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_prints_the_example_s_lines():
    port = _run(["-m", "repro_torch.apps.quickstart", "--device", "cpu"])
    ref = _run(["examples/quickstart.py"])
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    got, want = port.stdout.splitlines(), ref.stdout.splitlines()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        if "max err" not in w:
            assert g == w
            continue
        # "max err X.XXX, ..." -- the figure within one unit of its last
        # printed digit, the rest of the line equal
        gv, wv = (float(s.split("max err ")[1].split(",")[0])
                  for s in (g, w))
        assert abs(gv - wv) <= 1e-3 + 1e-9
        assert g.split(",")[1:] == w.split(",")[1:]


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    out = _run(["-m", "repro_torch.apps.quickstart"])
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.run()

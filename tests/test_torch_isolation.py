"""The port stands alone: no module of ``repro_torch`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package; the entry points run on
the card unless the caller asks for the CPU; and the smoke run refuses to
report anything without a card or without the repository beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def _run(args, cwd=REPO, timeout=300):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=timeout)


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_imports_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')\n"
        "for m in mods:\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_cli_runs_on_the_cpu_when_asked():
    out = _run(["-m", "repro_torch.apps.cnn", "--net", "mobilenet",
                "--res", "32", "--device", "cpu", "--select"])
    assert out.returncode == 0, out.stderr
    assert "per-layer selection" in out.stdout
    assert out.stdout.count("\n") > 28


def test_serve_cli_runs_on_the_cpu_when_asked():
    out = _run(["-m", "repro_torch.serve", "--smoke", "--device", "cpu",
                "--requests", "5", "--max-new", "6"])
    assert out.returncode == 0, out.stderr
    assert "serve-wide (energy-weighted)" in out.stdout
    assert out.stdout.count(" length ") == 5


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    for args in (["-m", "repro_torch.apps.cnn", "--res", "32"],
                 ["-m", "repro_torch.serve", "--smoke"]):
        out = _run(args)
        assert out.returncode != 0
        assert "CUDA is not available" in out.stderr
    from repro_torch.apps.cnn import analysis
    with pytest.raises(RuntimeError, match="device='cpu'"):
        analysis.analyze_network("mobilenet", n_images=1, res=32)


def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke would run for real")
    out = _run([str(REPO / "chip_smoke.py")])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

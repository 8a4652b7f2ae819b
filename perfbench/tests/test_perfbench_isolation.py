"""What the benchmark runs imports neither JAX nor the JAX package
(whole top-level names: ``repro_torch`` passes, ``repro`` fails); the
command refuses without a card and in a checkout without the port."""
import ast
import os
import shutil
import subprocess
import sys

from perfbench.harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    found = {}
    for path in core.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        bad = set(_imports(path)) & FORBIDDEN
        if bad:
            found[str(path)] = bad
    assert not found
    refs = [p for p in (core.BENCH_DIR / "reference").glob("*.py")]
    for path in refs:
        assert "repro_torch" not in set(_imports(path)), path


def test_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, str(core.BENCH_DIR))
    try:
        import run
    finally:
        sys.path.remove(str(core.BENCH_DIR))
    before = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake"] = object()
        assert "repro" not in run.forbidden_modules() or "repro" in before
        sys.modules["repro.fake"] = object()
        assert "repro" in run.forbidden_modules()
    finally:
        sys.modules.pop("repro_torch_fake", None)
        sys.modules.pop("repro.fake", None)


def _run(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "perfbench/run.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120)


def test_refuses_without_a_card():
    r = _run(core.ROOT, "--workload", "resnet50.analyze.b256", "--seed",
             str(2 ** 31 + 5), "--seconds", "1", "--trace", "0")
    assert r.returncode == 2 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_refuses_without_the_port(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, "--workload", "resnet50.analyze.b256", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""


def test_readings_tool_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "perfbench/tools/readings.py", "--workload",
         "resnet50.analyze.b256", "--seeds", "1,2"], cwd=core.ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and r.stdout == ""

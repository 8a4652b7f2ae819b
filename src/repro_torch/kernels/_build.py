"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` at the
repository root (``build/`` is git-ignored); the hash covers the source,
every shared header of ``csrc/`` and the flags, so an edited source or
header rebuilds and an unchanged one is reused. Several
sources compile in parallel, one ``nvcc`` each. Nothing here runs at
import time: the CPU tests import every module on machines without
``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE.parents[1] / "build" / "kernels"

#: every CUDA source of the port, by library name
SOURCES = ("power_counters", "zvg_matmul", "paged_attention", "transitions",
           "bic_encode", "zvg_tiled_matmul")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler; raises where there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every source of ``names`` not built yet, all at once.

    Each compiler's output (``-Xptxas -v``: registers, spills) is kept in
    ``build/kernels/<name>.log``. Raises with the compiler's messages if a
    build fails.
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    running = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        log = open(BUILD / f"{n}.log", "w")
        running[n] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in running.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[n])
        else:
            failed.append(f"{n} (nvcc exit {rc}):\n"
                          + (BUILD / f"{n}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, compiled first if needed."""
    return ctypes.CDLL(str(build_all((name,))[name]))

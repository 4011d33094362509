"""Build and load the hand-written CUDA kernels in ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch_kernels/`` at the repo root, then loaded with
``ctypes``. A library is named after the hash of its source, the headers
beside it (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one loads from disk. Nothing
is compiled at import time: the first kernel call builds what it needs,
and ``build_all()`` builds every source at once, one ``nvcc`` each, all
started together.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check()`` raises on anything but ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_attention", "flash_attention_bwd", "paged_attention", "ring_attention",
           "ssd_scan", "ssd_scan_bwd", "adamw")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every stale source in parallel; returns name → library path.

    The compiler's report (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``<lib>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = open(so.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (nvcc rc {rc}):\n"
                          + targets[name].with_suffix(".log").read_text())
            continue
        os.replace(tmp, targets[name])   # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return targets


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if stale) and load one kernel library; cached per process."""
    return ctypes.CDLL(str(build_all([name])[name]))


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")

"""Build hand-written CUDA kernels at first use and load them with ctypes.

Each kernel family is one ``.cu`` file with a plain C interface (no PyTorch
headers), compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root.  The library's name carries a
hash of the source, of the local headers it includes (``#include "..."``)
and of the flags, so an edited source or header builds anew and an
unchanged one loads from the earlier build.  Nothing here runs at import:
the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# src/repro_torch/kernels/_build.py -> repository root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time (0.0 when an earlier build was reused)
    log: str        # nvcc's output, with ptxas's per-kernel resource lines


_LIBRARIES: dict[Path, BuiltLibrary] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the port's kernels")
    return nvcc


def _local_includes(source: Path) -> list[Path]:
    """The headers ``source`` includes with quotes, transitively, each once
    (so headers that include each other end the walk)."""
    found: list[Path] = []
    todo = [source]
    while todo:
        path = todo.pop()
        for name in re.findall(r'^\s*#include\s+"([^"]+)"', path.read_text(),
                               re.MULTILINE):
            header = (path.parent / name).resolve()
            if header not in found:
                found.append(header)
                todo.append(header)
    return found


def load(source: Path) -> BuiltLibrary:
    """Compile ``source`` (once per process and source hash) and load it."""
    source = Path(source)
    if source in _LIBRARIES:
        return _LIBRARIES[source]
    digest = hashlib.sha256(b"".join(
        p.read_bytes() for p in (source, *_local_includes(source)))
        + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, "reused " + str(out)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    built = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
    _LIBRARIES[source] = built
    return built

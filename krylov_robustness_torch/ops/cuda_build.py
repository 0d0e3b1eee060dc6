"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for sm_90a into a shared
library with a plain C interface (``build/kernels/``, keyed on a hash of the
source, every shared header ``csrc/*.cuh`` and the flags) and loaded with
``ctypes``. A build happens at first
use, never at import; :func:`build_kernels` starts one ``nvcc`` per missing
library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"bsr_super": _CSRC / "bsr_super.cu",
           "banded_ell": _CSRC / "banded_ell.cu",
           "bsr_flat": _CSRC / "bsr_flat.cu",
           "block_mgs": _CSRC / "block_mgs.cu",
           "banded_sturm": _CSRC / "banded_sturm.cu"}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                           "toolkit to build")
    return path


def _target(name: str) -> Path:
    """The library path of one source, named by a hash of the source, the
    shared headers it may include (every ``*.cuh`` beside it, so that a
    changed header never reuses a stale library) and the flags."""
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_kernels(names=tuple(SOURCES)) -> dict[str, tuple[Path, float]]:
    """Compile each named source unless a library built from the same source
    and flags is there. Returns name → (library path, seconds from the start
    of the builds until its ``nvcc`` ended — 0.0 when it was already
    built)."""
    out: dict[str, tuple[Path, float]] = {}
    running = []
    t0 = time.perf_counter()
    for name in names:
        lib = _target(name)
        if lib.exists():
            out[name] = (lib, 0.0)
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {SOURCES[name].name}:\n{err}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source. The first call of a process builds
    every source that is missing, all at once, so that a fresh checkout
    waits for the slowest ``nvcc`` and not for their sum. The caller
    declares ``argtypes`` and ``restype`` of the functions it calls."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_kernels()[name][0]))
    return _LIBS[name]


def raise_on(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code (0 = success)."""
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code}")

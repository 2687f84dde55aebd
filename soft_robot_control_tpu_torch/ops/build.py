"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``build/torch_kernels/``
at the repository root and loaded with ``ctypes``. No PyTorch header is
included, so a build takes seconds. The library's file name carries a hash
of its source and headers, so an edited source is rebuilt at its next use. Nothing is
built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the library of `name` goes; the name carries a hash of the
    source and of every header (csrc/*.cuh) it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for `name` unless its library is current; returns
    (process, temporary output, final path) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                             str(CSRC / f"{name}.cu")],
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, tmp, out


def _finish(name: str, job) -> None:
    proc, tmp, out = job
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {rc}):\n"
                           + out.with_suffix(".log").read_text())
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file


def build_kernels(names) -> float:
    """Build every named kernel, one nvcc per source, all started at once.
    Returns the wall time in seconds."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    current build of `name`, or "" if it was built by another process."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed, with
    `signatures` ({function: (restype, argtypes)}) declared. The source's
    hash is read once per process."""
    lib = _loaded.get(name)
    if lib is None:
        build_kernels([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib

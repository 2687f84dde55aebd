"""ctypes bindings for the native IO runtime (csrc/srk_io.cpp).

The repository's C++ source, as it is, is built with g++ on first use into
build/native/ at the repository root (beside the CUDA kernels'
build/torch_kernels/); the library's name carries a hash of the source,
so an edited source is rebuilt at its next use. Where no compiler is
available the functions fall back to numpy, as in the JAX package: this
is a host IO helper, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
_SRC = os.path.join(_ROOT, "csrc", "srk_io.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> str:
    """Where the library goes: its name carries a hash of the source."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libsrk_io-{h}.so")


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = library_path()
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
        except Exception:
            _build_failed = True
            return None
        lib.srk_parse_matrix_txt.restype = ctypes.c_longlong
        lib.srk_parse_matrix_txt.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong]
        lib.srk_snaplog_open.restype = ctypes.c_void_p
        lib.srk_snaplog_open.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        lib.srk_snaplog_append.restype = ctypes.c_int
        lib.srk_snaplog_append.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_double)]
        lib.srk_snaplog_append_many.restype = ctypes.c_int
        lib.srk_snaplog_append_many.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong]
        lib.srk_snaplog_flush.restype = ctypes.c_int
        lib.srk_snaplog_flush.argtypes = [ctypes.c_void_p]
        lib.srk_snaplog_close.restype = ctypes.c_int
        lib.srk_snaplog_close.argtypes = [ctypes.c_void_p]
        lib.srk_snaplog_read.restype = ctypes.c_longlong
        lib.srk_snaplog_read.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_double), ctypes.c_longlong]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def parse_matrix_txt(path: str, rows: int, cols: int,
                     skip_lines: int = 0) -> np.ndarray:
    """Parse a whitespace/bracket text matrix (the SOFA LDL export format,
    utils.py:186-194) into a (rows, cols) float64 array."""
    lib = _load()
    if lib is not None:
        out = np.empty(rows * cols, dtype=np.float64)
        n = lib.srk_parse_matrix_txt(
            path.encode(), skip_lines,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), out.size)
        if n < 0:
            raise IOError(f"cannot read {path}")
        if n != rows * cols:
            raise ValueError(f"expected {rows * cols} values, parsed {n}")
        return out.reshape(rows, cols)
    # numpy fallback
    with open(path) as f:
        lines = f.readlines()[skip_lines:]
    vals = []
    for line in lines:
        vals.extend(float(v) for v in
                    line.replace("[", " ").replace("]", " ").replace(",", " ").split())
    arr = np.asarray(vals, dtype=np.float64)
    if arr.size != rows * cols:
        raise ValueError(f"expected {rows * cols} values, parsed {arr.size}")
    return arr.reshape(rows, cols)


class SnapLog:
    """Append-only binary record log (fixed float64 record width)."""

    def __init__(self, path: str, record_width: int):
        self.path = path
        self.width = int(record_width)
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.srk_snaplog_open(path.encode(), self.width)
            if not self._h:
                raise IOError(f"cannot open {path}")
            self._buf = None
        else:
            self._h = None
            self._buf = []

    def append(self, record) -> None:
        rec = np.ascontiguousarray(record, dtype=np.float64).reshape(-1)
        if rec.size != self.width:
            raise ValueError(f"record width {rec.size} != {self.width}")
        if self._h is not None:
            rc = self._lib.srk_snaplog_append(
                self._h, rec.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            if rc != 0:
                raise IOError("snaplog append failed")
        else:
            self._buf.append(rec)

    def append_many(self, records) -> None:
        recs = np.ascontiguousarray(records, dtype=np.float64)
        if recs.shape[-1] != self.width:
            raise ValueError("record width mismatch")
        if self._h is not None:
            rc = self._lib.srk_snaplog_append_many(
                self._h, recs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                recs.reshape(-1, self.width).shape[0])
            if rc != 0:
                raise IOError("snaplog append failed")
        else:
            self._buf.extend(recs.reshape(-1, self.width))

    def flush(self) -> None:
        if self._h is not None:
            self._lib.srk_snaplog_flush(self._h)

    def close(self) -> None:
        if self._h is not None:
            self._lib.srk_snaplog_close(self._h)
            self._h = None
        elif self._buf is not None:
            arr = np.asarray(self._buf, dtype=np.float64)
            with open(self.path, "wb") as f:
                f.write((0x534E41504C4F4731).to_bytes(8, "little"))
                f.write(int(self.width).to_bytes(8, "little"))
                f.write(arr.tobytes())
            self._buf = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_snaplog(path: str) -> np.ndarray:
    """Read a snaplog back as an (n_records, width) array."""
    lib = _load()
    if lib is not None:
        width = ctypes.c_longlong(0)
        n = lib.srk_snaplog_read(path.encode(), ctypes.byref(width), None, 0)
        if n < 0:
            raise IOError(f"cannot read {path}")
        out = np.empty(n * width.value, dtype=np.float64)
        lib.srk_snaplog_read(path.encode(), ctypes.byref(width),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                             out.size)
        return out.reshape(n, width.value)
    with open(path, "rb") as f:
        magic = int.from_bytes(f.read(8), "little")
        if magic != 0x534E41504C4F4731:
            raise IOError("bad snaplog magic")
        width = int.from_bytes(f.read(8), "little")
        data = np.frombuffer(f.read(), dtype=np.float64)
    return data.reshape(-1, width)

"""The native (C++) HITRAN ``.par`` parser, bound with ctypes.

Counterpart of ``clearsky_tpu.native``: ``parparse.cpp`` (the port's own
copy) parses the numeric columns of a ``.par`` file in one multithreaded
pass. It is host code, not a kernel. The shared library is built with
``g++`` at first use into ``build/clearsky_tpu_torch/native/`` at the
repository root (git-ignored), named by a hash of the source and the
flags; where no compiler is found or the build fails, :func:`parse_par_native`
returns None and ``spectra.par.read_par`` takes its numpy path, which gives
the same numbers. ``CLEARSKY_TPU_NO_NATIVE=1`` turns the native path off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["parse_par_native", "native_available", "library_path"]

_SRC = Path(__file__).resolve().parent / "parparse.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "clearsky_tpu_torch" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> Path:
    """Where the build goes: named by a hash of the source and the flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update("\0".join(FLAGS).encode())
    return BUILD_DIR / f"libparparse_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Compile under a temporary name and rename: a concurrent process sees
    no library or a whole one."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".parparse_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *FLAGS, str(_SRC), "-o", tmp], capture_output=True,
                              timeout=120)
        if proc.returncode != 0:
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("CLEARSKY_TPU_NO_NATIVE"):
            return None
        out = library_path()
        if not out.is_file() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        D = ctypes.POINTER(ctypes.c_double)
        lib.clearsky_parse_par.restype = ctypes.c_int64
        lib.clearsky_parse_par.argtypes = [
            ctypes.c_char_p, *(ctypes.POINTER(D) for _ in range(8)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ]
        lib.clearsky_free.restype = None
        lib.clearsky_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def parse_par_native(path: str) -> dict | None:
    """The numeric columns of a ``.par`` file (M, I, nu, S, A, ga, gs, Epp,
    na, da) from the C++ parser, or None where the library is unavailable or
    a field does not parse (the numpy path then raises with context)."""
    lib = _load()
    if lib is None:
        return None
    D = ctypes.POINTER(ctypes.c_double)
    fptrs = [D() for _ in range(8)]
    Mp = ctypes.POINTER(ctypes.c_int16)()
    Ip = ctypes.POINTER(ctypes.c_char)()
    n = lib.clearsky_parse_par(str(path).encode(), *(ctypes.byref(p) for p in fptrs),
                               ctypes.byref(Mp), ctypes.byref(Ip))
    if n < 0:
        raise OSError(f"native parser failed to read {path}")
    out = {}
    try:
        for k, p in zip(("nu", "S", "A", "ga", "gs", "Epp", "na", "da"), fptrs):
            out[k] = np.ctypeslib.as_array(p, shape=(n,)).copy() if n else np.empty(0)
            if np.isnan(out[k]).any():
                return None
        out["M"] = (np.ctypeslib.as_array(Mp, shape=(n,)).copy() if n
                    else np.empty(0, np.int16))
        raw = ctypes.cast(Ip, ctypes.POINTER(ctypes.c_char * n)) if n else None
        out["I"] = (np.frombuffer(bytes(raw.contents), dtype="S1").astype("U1") if n
                    else np.empty(0, dtype="U1"))
    finally:
        for p in fptrs:
            lib.clearsky_free(p)
        lib.clearsky_free(Mp)
        lib.clearsky_free(Ip)
    return out

"""Build the CUDA sources of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and includes no PyTorch
header, so ``nvcc`` builds it in seconds into a shared library. The library
lands in ``build/clearsky_tpu_torch/`` at the repository root, named by a hash
of its source, every header of ``csrc/`` (``*.cuh``) and the compiler flags:
an edited source or header is rebuilt, an unchanged one is loaded from the
earlier build.

The flags carry no ``--use_fast_math``: it would flush subnormals to zero and
swap ``expf`` for its fast approximation, and the march's series/exp split
and CIA-scale cross-sections depend on IEEE float32.

:func:`check_operand` holds a tensor to what a kernel takes before its raw
pointer crosses the C interface, and refuses one that carries a derivative.
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

import torch

from .twin import refuse_derivatives

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "library_path", "build_library", "load_library",
           "check_operand"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "clearsky_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "are compiled from csrc/ at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes: named by a hash of the
    source, of every ``csrc/*.cuh`` (name and bytes) and of the flags."""
    h = hashlib.sha256(CSRC.joinpath(f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of the same sources exists."""
    src = CSRC / f"{name}.cu"
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: a concurrent process either
    # sees no library or a whole one
    fd, tmp = tempfile.mkstemp(prefix=f".{name}_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build_library(name)))
        return lib


def check_operand(name, x, shape, device, dtype=torch.float32):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` that carries no derivative (:func:`.twin.refuse_derivatives`:
    its raw pointer crosses the C interface, where a derivative is lost)."""
    refuse_derivatives(name, x)
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, the kernel takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

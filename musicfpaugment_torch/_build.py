"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, on first use, under ``build/<hash>/`` in
this package (``.gitignore``d). The hash covers the sources and the flags,
so an edited source builds anew and an unchanged one is loaded as it is.
The library is opened with ``ctypes``; pointers and the stream go in as
``c_void_p``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from typing import List, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # the 32 kernel instances are optimised in parallel (CUDA 12.1 or later)
    "--split-compile", "0",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/peaks_prune.cu
_SIGNATURES = {
    # sgram, out, gauss, B, C, F, a_dec, maxpks, stream
    "mfpa_forward_prune": [_P, _P, _P, _I, _I, _I, _F, _I, _P],
    # sgram, peaks, valid_frames (nullable), out, gauss, B, C, F, a_dec, maxpks, stream
    "mfpa_backward_prune": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
}


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    )
    if not cand or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return cand


def _digest(srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels if this source set has no library yet; returns
    the library's path. Raises with nvcc's output on failure."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out_dir = os.path.join(BUILD_DIR, _digest(srcs))
    lib_path = os.path.join(out_dir, "libmfpa_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    if verbose:  # ptxas register / spill report
        print(proc.stderr, end="", file=sys.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib

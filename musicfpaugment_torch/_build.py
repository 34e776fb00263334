"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all at
once, and the objects are linked into one shared library with a plain C
interface, on first use, under ``build/<hash>/`` in this package
(``.gitignore``d). The hash covers the sources and the flags,
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # a file's kernel instances are optimised in parallel (CUDA 12.1 or later)
    "--split-compile", "0",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
# C signatures of csrc/peaks_prune.cu, csrc/dropout_threefry.cu,
# csrc/union_hashes.cu and csrc/rope_qk.cu; each returns an int (a
# cudaError_t) unless _RESTYPES says otherwise
_SIGNATURES = {
    # sgram, out, gauss, B, C, F, a_dec, maxpks, stream
    "mfpa_forward_prune": [_P, _P, _P, _I, _I, _I, _F, _I, _P],
    # sgram, peaks, valid_frames (nullable), out, gauss, B, C, F, a_dec, maxpks, stream
    "mfpa_backward_prune": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # x, out, dtype, B, C, H, W, k0, k1, offset, keep, keep_t, stream
    "mfpa_dropout_threefry": [_P, _P, _I, _I64, _I, _I, _I, _U32, _U32, _U64, _F, _F, _P],
    # S, B, F, c_max, peak_total
    "mfpa_union_hashes_scratch_bytes": [_I, _I, _I, _I, _I],
    # shifts (host table), S, B, F, c_max, peak_total, out_len, scratch,
    # times, hashes, n_valid, stream
    "mfpa_union_hashes": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # qkv, cos, sin, out, S, n, heads, stream
    "mfpa_rope_qk": [_P, _P, _P, _P, _I, _I, _I, _P],
}
_RESTYPES = {"mfpa_union_hashes_scratch_bytes": _I64}


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
    nvcc = _nvcc()
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs = [os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o") for src in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(srcs, objs)
    ]
    try:
        failed = []
        for src, proc in zip(srcs, procs):
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} ({proc.returncode}):\n{out}\n{err}")
            elif verbose:  # ptxas register / spill report
                print(err, end="", file=sys.stderr)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = f"{lib_path}.{tag}.tmp"
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"linking failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
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
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = lib
    return _lib

"""ctypes bindings over the repo's native C++ audio decoders (``native/*.cc``).

The library is compiled by ``g++`` on first use from ``native/wavio.cc``,
``native/mp3io.cc`` and ``native/loader.cc`` into
``musicfpaugment_torch/build/<hash>/libmfpa_native.so`` (``.gitignore``d);
the hash covers the sources and the flags, so an edited source builds anew.
A failed build raises with the compiler's output, a library that does not
load raises with the loader's message: nothing falls back quietly.

``mp3io.cc`` opens the system ``libmpg123.so.0`` with ``dlopen`` when it
first decodes, so the build does not need it; :func:`mp3_available` says
whether it loaded.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(PKG_DIR), "native")
BUILD_DIR = os.path.join(PKG_DIR, "build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LIBS = ["-lpthread", "-ldl"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("frames", ctypes.c_int64),
        ("bits_per_sample", ctypes.c_int32),
        ("format", ctypes.c_int32),
    ]


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cc")))


def _digest(srcs: List[str]) -> str:
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS, *LIBS]).encode())
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the library if this source set has none yet; returns its
    path. Raises with the compiler's output on failure."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no native sources under {NATIVE_DIR}")
    out_dir = os.path.join(BUILD_DIR, _digest(srcs))
    lib_path = os.path.join(out_dir, "libmfpa_native.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", tmp, *srcs, *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the native decoders: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"{CXX} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path


def _bind_symbols(lib: ctypes.CDLL) -> None:
    info_p = ctypes.POINTER(_WavInfo)
    out_pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    for name in ("mfpa_wav_metadata", "mfpa_mp3_metadata"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, info_p]
        fn.restype = ctypes.c_int
    for name in ("mfpa_read_wav", "mfpa_read_mp3", "mfpa_read_audio"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p, out_pp, info_p]
        fn.restype = ctypes.c_int
    lib.mfpa_mp3_available.argtypes = []
    lib.mfpa_mp3_available.restype = ctypes.c_int
    lib.mfpa_free.argtypes = [ctypes.c_void_p]
    lib.mfpa_free.restype = None
    lib.mfpa_read_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        info_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.mfpa_read_wav_batch.restype = None


def library() -> ctypes.CDLL:
    """The loaded library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _bind_symbols(lib)
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def wav_metadata(path: str) -> Tuple[int, int]:
    """(num_frames, sample_rate) from the header alone."""
    info = _WavInfo()
    rc = library().mfpa_wav_metadata(str(path).encode(), ctypes.byref(info))
    if rc != 0:
        raise IOError(f"wav_metadata({path}) failed with code {rc}")
    return int(info.frames), int(info.sample_rate)


def _to_array(ptr, info: _WavInfo, lib: ctypes.CDLL) -> np.ndarray:
    n = info.frames * info.channels
    buf = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.mfpa_free(ptr)
    return np.ascontiguousarray(
        buf.reshape(info.frames, info.channels).T.astype(np.float32)
    )


def _read(fn_name: str, path: str) -> Tuple[np.ndarray, int]:
    lib = library()
    info = _WavInfo()
    ptr = ctypes.POINTER(ctypes.c_float)()
    rc = getattr(lib, fn_name)(str(path).encode(), ctypes.byref(ptr), ctypes.byref(info))
    if rc != 0:
        raise IOError(f"{fn_name}({path}) failed with code {rc}")
    return _to_array(ptr, info, lib), int(info.sample_rate)


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode to ((channels, frames) float32 in [-1, 1], sample_rate)."""
    return _read("mfpa_read_wav", path)


def mp3_available() -> bool:
    """Whether the system libmpg123 could be loaded (the library must
    build: this raises if it does not)."""
    return bool(library().mfpa_mp3_available())


def _require_mp3(path: str) -> None:
    if not mp3_available():
        raise IOError(
            f"cannot decode {path}: libmpg123.so.0 could not be loaded "
            "(native/mp3io.cc opens it at run time)"
        )


def mp3_metadata(path: str) -> Tuple[int, int]:
    """(num_frames, sample_rate) by a stream scan (no PCM decode)."""
    _require_mp3(path)
    info = _WavInfo()
    rc = library().mfpa_mp3_metadata(str(path).encode(), ctypes.byref(info))
    if rc != 0:
        raise IOError(f"mp3_metadata({path}) failed with code {rc}")
    return int(info.frames), int(info.sample_rate)


def read_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decode an mp3 to ((channels, frames) float32, sample_rate) through
    the system libmpg123."""
    _require_mp3(path)
    return _read("mfpa_read_mp3", path)


def read_wav_batch(
    paths: List[str], num_threads: int = 0
) -> List[Optional[Tuple[np.ndarray, int]]]:
    """Decode WAV and mp3 files on a pool of native threads (dispatched by
    extension); ``None`` for a file that failed. ``num_threads`` 0 takes
    the machine's hardware concurrency."""
    lib = library()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_float) * n)()
    infos = (_WavInfo * n)()
    rcs = (ctypes.c_int * n)()
    lib.mfpa_read_wav_batch(c_paths, n, outs, infos, rcs, num_threads)
    results: List[Optional[Tuple[np.ndarray, int]]] = []
    for i in range(n):
        if rcs[i] != 0:
            results.append(None)
            continue
        results.append((_to_array(outs[i], infos[i], lib), int(infos[i].sample_rate)))
    return results

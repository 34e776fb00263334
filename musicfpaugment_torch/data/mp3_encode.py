"""mp3 encoding through the system libmp3lame (ctypes).

The inverse of the libmpg123 decode (``data/native.py``): it writes mp3
corpora for tests and smoke runs where no lame binary is installed.
``available()`` says whether libmp3lame could be loaded.

A rate and bit-rate pair that ``lame_init_params`` refuses raises. The
tests and ``chip_smoke.py`` encode at 22.05 kHz, as
``tests/make_mp3_fixture.py`` does.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lame: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _bind(lame: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lame.lame_init.argtypes = []
    lame.lame_init.restype = vp
    for name in ("lame_set_in_samplerate", "lame_set_num_channels", "lame_set_mode",
                 "lame_set_brate"):
        fn = getattr(lame, name)
        fn.argtypes = [vp, i]
        fn.restype = i
    for name in ("lame_init_params", "lame_close"):
        fn = getattr(lame, name)
        fn.argtypes = [vp]
        fn.restype = i
    lame.lame_encode_buffer.argtypes = [
        vp, ctypes.POINTER(ctypes.c_short), ctypes.POINTER(ctypes.c_short), i,
        ctypes.POINTER(ctypes.c_ubyte), i,
    ]
    lame.lame_encode_buffer.restype = i
    lame.lame_encode_flush.argtypes = [vp, ctypes.POINTER(ctypes.c_ubyte), i]
    lame.lame_encode_flush.restype = i


def _load() -> Optional[ctypes.CDLL]:
    global _lame, _error
    with _lock:
        if _lame is None and _error is None:
            try:
                lame = ctypes.CDLL(ctypes.util.find_library("mp3lame") or "libmp3lame.so.0")
                _bind(lame)
                _lame = lame
            except (OSError, AttributeError) as e:
                _error = str(e)
    return _lame


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """The loader's message when libmp3lame could not be loaded."""
    _load()
    return _error


def encode_mp3(
    samples: np.ndarray, path: str, sample_rate: int, bitrate_kbps: int = 128
) -> None:
    """Encode mono float32 samples in [-1, 1] to an mp3 file."""
    lame = _load()
    if lame is None:
        raise RuntimeError(f"libmp3lame not available: {_error}")
    samples = np.asarray(samples, np.float32).reshape(-1)
    gfp = lame.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lame.lame_set_in_samplerate(gfp, int(sample_rate))
        lame.lame_set_num_channels(gfp, 1)
        lame.lame_set_mode(gfp, 3)  # MONO
        lame.lame_set_brate(gfp, int(bitrate_kbps))
        if lame.lame_init_params(gfp) < 0:
            raise RuntimeError(
                f"lame_init_params refused {sample_rate} Hz at {bitrate_kbps} kbit/s"
            )
        n = len(samples)
        out_size = int(1.25 * n + 7200)
        out = (ctypes.c_ubyte * out_size)()
        pcm = np.ascontiguousarray(np.clip(samples * 32767.0, -32768, 32767).astype(np.int16))
        written = lame.lame_encode_buffer(
            gfp, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short)), None, n, out, out_size
        )
        if written < 0:
            raise RuntimeError(f"lame_encode_buffer failed: {written}")
        tail_buf = (ctypes.c_ubyte * (out_size - written)).from_buffer(out, written)
        tail = lame.lame_encode_flush(gfp, tail_buf, out_size - written)
        if tail < 0:
            raise RuntimeError(f"lame_encode_flush failed: {tail}")
        with open(path, "wb") as f:
            f.write(bytes(out[: written + tail]))
    finally:
        lame.lame_close(gfp)

"""Batched STFT (port of musicfpaugment_tpu/core/stft.py).

Reflect-padded centered frames, periodic Hann window, rfft; returned
frequency-major ``(..., n_fft // 2 + 1, frames)`` like the JAX version.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def periodic_hann(window_length: int) -> np.ndarray:
    """Periodic Hann window, ``np.hanning(n + 2)[1:-1]`` semantics."""
    return np.hanning(window_length + 2)[1:-1].astype(np.float32)


def frame(signal: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """``(..., T)`` -> ``(..., 1 + (T - frame_length) // hop_length,
    frame_length)`` overlapping frames (a strided view)."""
    return signal.unfold(-1, frame_length, hop_length)


def stft(
    signal: torch.Tensor,
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
) -> torch.Tensor:
    """Complex spectrogram ``(..., n_fft // 2 + 1, num_frames)``."""
    if window is None:
        window = torch.from_numpy(periodic_hann(n_fft)).to(signal.device)
    window_length = window.shape[-1]
    if hop_length is None:
        hop_length = window_length // 2
    if center:
        # reflect padding needs a (N, C, T) input
        lead = signal.shape[:-1]
        flat = signal.reshape(-1, 1, signal.shape[-1])
        half = n_fft // 2
        signal = F.pad(flat, (half, half), mode="reflect").reshape(*lead, -1)
    frames = frame(signal, window_length, hop_length)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    return spec.transpose(-1, -2)


def magnitude_spectrogram(
    waveform: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 256,
    per_example: bool = False,
    eps: float = 0.0,
) -> torch.Tensor:
    """|STFT| divided by its max (global, or per example with
    ``per_example=True``)."""
    mag = torch.abs(stft(waveform, n_fft=n_fft, hop_length=hop_length))
    if per_example:
        denom = torch.amax(mag, dim=(-2, -1), keepdim=True)
    else:
        denom = torch.amax(mag)
    floor = eps if eps > 0 else torch.finfo(mag.dtype).tiny
    return mag / torch.clamp(denom, min=floor)

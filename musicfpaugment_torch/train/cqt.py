"""Constant-Q transform and the CQT losses (port of
musicfpaugment_tpu/train/cqt.py).

The CQT is a framed filterbank: log-spaced complex kernels (Q = 1 /
(2^(1/bpo) - 1), Hann-windowed complex exponentials, l1-normalised, centred
in the longest kernel's frame), applied as one (frames x kernel_len) @
(kernel_len x bins) product per real and imaginary part. The losses'
norms and means accumulate in float64: a float32 ``vector_norm`` over the
~500k magnitudes of 8 clips of 3 s is ~8e-6 off (PyTorch's CPU sum), which
alone would move the spectral-convergence term by 1e-5. The losses are
defined for parity and used by no default training run, as in the JAX
package.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from musicfpaugment_torch.core.stft import frame


@functools.lru_cache(maxsize=None)
def _cqt_kernels(
    sr: int, f_min: float, f_max: float, bins_per_octave: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """(kernel_len, n_bins) real and imaginary kernel banks."""
    n_bins = int(math.ceil(bins_per_octave * math.log2(f_max / f_min)))
    q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    freqs = f_min * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    lengths = np.ceil(q * sr / freqs).astype(int)
    max_len = int(lengths.max())
    kr = np.zeros((max_len, n_bins), np.float32)
    ki = np.zeros((max_len, n_bins), np.float32)
    for k in range(n_bins):
        n = int(lengths[k])
        start = (max_len - n) // 2
        win = np.hanning(n)
        phase = 2.0 * np.pi * freqs[k] * (np.arange(n) - n / 2) / sr
        kern = win * np.exp(1j * phase)
        kern = kern / np.abs(kern).sum()
        kr[start : start + n, k] = kern.real
        ki[start : start + n, k] = kern.imag
    return kr, ki, max_len


def cqt_magnitude(
    x: torch.Tensor,
    sr: int = 8000,
    f_min: float = 32.70,
    f_max: float = 4186.009,
    bins_per_octave: int = 48,
    hop_length: int = 512,
) -> torch.Tensor:
    """(..., T) -> (..., n_bins, frames) CQT magnitude, clamped at 1e-7;
    reflect-padded by half the longest kernel on each side (the kernel is
    16,820 samples long for 48 bins an octave from 32.7 Hz at 8 kHz)."""
    kr, ki, max_len = _cqt_kernels(sr, f_min, float(min(f_max, sr / 2 * 0.99)), bins_per_octave)
    pad = max_len // 2
    # numpy's reflect padding, which reflects again where the pad is longer
    # than the signal (F.pad refuses that)
    idx = np.pad(np.arange(x.shape[-1]), pad, mode="reflect")
    xp = x[..., torch.from_numpy(idx).to(x.device)]
    frames = frame(xp, max_len, hop_length)  # (..., frames, max_len)
    real = frames @ torch.from_numpy(kr).to(x.device, x.dtype)
    imag = frames @ torch.from_numpy(ki).to(x.device, x.dtype)
    mag = torch.sqrt(real**2 + imag**2)
    return torch.clamp(mag.transpose(-1, -2), min=1e-7)


def cqt_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    f_min: float,
    f_max: float,
    bins_per_octave: int,
    hop_length: int,
    sr: int = 8000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude L1) of one CQT configuration."""
    x_mag = cqt_magnitude(x, sr, f_min, f_max, bins_per_octave, hop_length)
    y_mag = cqt_magnitude(y, sr, f_min, f_max, bins_per_octave, hop_length)
    acc = torch.float64
    sc = torch.linalg.vector_norm(y_mag - x_mag, dtype=acc) / torch.linalg.vector_norm(y_mag, dtype=acc)
    mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)), dtype=acc)
    return sc.to(x.dtype), mag.to(x.dtype)


def multi_resolution_cqt_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    f_min: Sequence[float] = (32.70, 32.70, 32.70),
    f_max: Sequence[float] = (4186.009, 4186.009, 4186.009),
    bins_per_octave: Sequence[int] = (48, 36, 24),
    hop_sizes: Sequence[int] = (512, 128, 64),
    factor_sc: float = 0.1,
    factor_mag: float = 0.1,
    sr: int = 8000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CQT losses averaged over the resolutions, each scaled by its
    factor."""
    if not len(f_min) == len(f_max) == len(bins_per_octave) == len(hop_sizes):
        raise ValueError("the CQT resolutions differ in number")
    sc_loss = 0.0
    mag_loss = 0.0
    for f_mi, f_ma, bpo, hs in zip(f_min, f_max, bins_per_octave, hop_sizes):
        sc, mag = cqt_loss(x, y, f_mi, f_ma, bpo, hs, sr)
        sc_loss = sc_loss + sc
        mag_loss = mag_loss + mag
    n = len(f_min)
    return factor_sc * sc_loss / n, factor_mag * mag_loss / n

"""Training losses and scores (port of musicfpaugment_tpu/train/losses.py).

L1, and the multi-resolution STFT loss: the mean over three resolutions
(fft 1024/2048/512, hop 120/240/50, win 600/1200/240) of spectral
convergence (Frobenius) and log-magnitude L1, each scaled by a factor (0.1
by default, 0.5 from the training CLI). ``torch.stft``'s conventions are
kept: a periodic Hann of ``win_length`` zero-padded centred to
``fft_size``, reflect-pad centring, magnitude clamped at 1e-7 (squared).
The spectra go through the port's ``core.stft`` (cuFFT on the card); the
JAX package's DFT-as-matmul form is a TPU layout and is not ported.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from musicfpaugment_torch.core.stft import stft as _stft


@functools.lru_cache(maxsize=None)
def _torch_hann_padded(win_length: int, fft_size: int) -> np.ndarray:
    """torch.hann_window(win_length) (periodic), centred in fft_size zeros
    as torch.stft does when win_length < n_fft."""
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))
    left = (fft_size - win_length) // 2
    out = np.zeros(fft_size, np.float32)
    out[left : left + win_length] = win
    return out


def stft_magnitude(
    x: torch.Tensor, fft_size: int, hop_size: int, win_length: int
) -> torch.Tensor:
    """(B, T) -> (B, frames, bins) clamped magnitude."""
    window = torch.from_numpy(_torch_hann_padded(win_length, fft_size)).to(x.device)
    spec = _stft(x, n_fft=fft_size, hop_length=hop_size, window=window)
    # |z|^2 as re^2 + im^2: the same value, and a gradient that exists at 0
    power = spec.real.square() + spec.imag.square()
    return torch.sqrt(torch.clamp(power, min=1e-7)).transpose(-1, -2)


def spectral_convergence_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """||y - x||_F / ||y||_F over the whole tensor."""
    return torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(y_mag)


def log_stft_magnitude_loss(x_mag: torch.Tensor, y_mag: torch.Tensor) -> torch.Tensor:
    """L1 between log magnitudes."""
    return torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))


def stft_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    fft_size: int = 1024,
    shift_size: int = 120,
    win_length: int = 600,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sc_loss, mag_loss) for one resolution."""
    x_mag = stft_magnitude(x, fft_size, shift_size, win_length)
    y_mag = stft_magnitude(y, fft_size, shift_size, win_length)
    return spectral_convergence_loss(x_mag, y_mag), log_stft_magnitude_loss(x_mag, y_mag)


def multi_resolution_stft_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    fft_sizes: Sequence[int] = (1024, 2048, 512),
    hop_sizes: Sequence[int] = (120, 240, 50),
    win_lengths: Sequence[int] = (600, 1200, 240),
    factor_sc: float = 0.1,
    factor_mag: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-over-resolutions (sc, mag) losses, scaled by the factors."""
    if not len(fft_sizes) == len(hop_sizes) == len(win_lengths):
        raise ValueError("fft_sizes, hop_sizes and win_lengths differ in length")
    sc_loss = 0.0
    mag_loss = 0.0
    for fs, ss, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc_l, mag_l = stft_loss(x, y, fs, ss, wl)
        sc_loss = sc_loss + sc_l
        mag_loss = mag_loss + mag_l
    n = len(fft_sizes)
    return factor_sc * sc_loss / n, factor_mag * mag_loss / n


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean |x - y|. Its gradient at x == y is +1 / N, as ``jnp.abs``'s is
    (``torch.abs`` takes 0 there): a UNet at initialisation meets such ties
    where a pixel's ReLUs are all off and the clean frame is silent."""
    d = x - y
    return torch.mean(torch.where(d >= 0, d, -d))


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, micro-averaged over the whole
    tensors, the data range taken from the two tensors themselves
    (torchmetrics' ``PeakSignalNoiseRatio(average="micro")``)."""
    data_range = torch.maximum(pred, target).max() - torch.minimum(pred, target).min()
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))

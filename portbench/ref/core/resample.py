"""Sinc resampling (port of musicfpaugment_tpu/core/resample.py).

* ``upsample2`` / ``downsample2``: the x2 sinc interpolation pair used inside
  Demucs, a 56-zero Hann-windowed sinc with the reference's padding and
  trimming.
* ``resample_frac``: the polyphase windowed-sinc rational resampler used
  when queries are loaded at another rate (an identity at 1:1).

The x2 pair is one 112-tap, one-channel correlation over the trailing
axis, run through ``core/convolve.fft_convolve`` (cuFFT on the card). Over
128 rows, in three runs of ``chip_smoke.py``'s ``demucs`` phase on an NVIDIA
H100 80GB HBM3 at 700 W, it beat cuDNN's ``F.conv1d`` at the 128,170
samples of a Demucs forward of 8 s queries every time (0.54-0.63 against
0.89-1.04 ms) and at 64,085 samples in two runs of three, and it lies
nearer float64. The JAX package's Toeplitz matmul and its x4 phase bases
(``up4_phase_basis``, ``down4_phase_basis``) are layouts for the TPU's
matrix unit and are not ported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.ref.core.convolve import fft_convolve


def _sinc(t: np.ndarray) -> np.ndarray:
    return np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))


@functools.lru_cache(maxsize=None)
def _kernel_updown2(zeros: int = 56) -> np.ndarray:
    """The half-sample sinc kernel shared by the x2 pair, ``2 * zeros`` taps
    (float32; symmetric Hann as ``np.hanning``, torch's ``periodic=False``)."""
    win = np.hanning(4 * zeros + 1)
    winodd = win[1::2]
    t = np.linspace(-zeros + 0.5, zeros - 0.5, 2 * zeros) * math.pi
    return (_sinc(t) * winodd).astype(np.float32)


def _conv1d_same_padded(x: torch.Tensor, zeros: int) -> torch.Tensor:
    """``F.conv1d(x, kernel, padding=zeros)`` (a correlation: the kernel is
    flipped for the convolution) on the trailing axis of ``x``, any leading
    dims."""
    kernel = torch.from_numpy(_kernel_updown2(zeros)[::-1].copy()).to(x.device, x.dtype)
    return fft_convolve(F.pad(x, (zeros, zeros)), kernel, mode="valid")


def upsample2(x: torch.Tensor, zeros: int = 56) -> torch.Tensor:
    """Upsample the trailing axis by 2: even samples are the input, odd
    samples its sinc interpolation."""
    out = _conv1d_same_padded(x, zeros)[..., 1:]
    return torch.stack([x, out], dim=-1).reshape(*x.shape[:-1], -1)


def downsample2(x: torch.Tensor, zeros: int = 56) -> torch.Tensor:
    """Downsample the trailing axis by 2 (an odd length is zero-padded by
    one sample first)."""
    if x.shape[-1] % 2 != 0:
        x = F.pad(x, (0, 1))
    xeven = x[..., ::2]
    xodd = x[..., 1::2]
    out = xeven + _conv1d_same_padded(xodd, zeros)[..., :-1]
    return out * 0.5


@functools.lru_cache(maxsize=None)
def _frac_kernels(old: int, new: int, zeros: int, rolloff: float):
    """(new, K) float32 polyphase kernels and the half-width ``width``."""
    # anti-aliasing cutoff as a fraction of the *input* sample rate
    sr_cut = rolloff * min(1.0, new / old) * 0.5 / old
    width = math.ceil(zeros / (2 * sr_cut))
    idx = np.arange(-width, width + old, dtype=np.float64)
    kernels = []
    for phase in range(new):
        t = (idx - phase * old / new) * 2 * math.pi * sr_cut
        t_lim = zeros * math.pi
        window = np.cos(np.clip(t / zeros / 2, -math.pi / 2, math.pi / 2)) ** 2
        kern = np.where(np.abs(t) <= t_lim, _sinc(t) * window, 0.0)
        kernels.append(2 * sr_cut * kern)
    return np.stack(kernels).astype(np.float32), width


def resample_frac(
    x: torch.Tensor, old_sr: int, new_sr: int, zeros: int = 24, rolloff: float = 0.945
) -> torch.Tensor:
    """Rational windowed-sinc resampler on the trailing axis: for each of
    ``new_sr // gcd`` output phases a fixed sinc kernel is correlated with
    the input at stride ``old_sr // gcd`` (julius / torchaudio
    ``sinc_interp_hann`` style). Output length ``ceil(T * new / old)``."""
    g = math.gcd(old_sr, new_sr)
    old, new = old_sr // g, new_sr // g
    if old == new:
        return x
    T = x.shape[-1]
    kernels_np, width = _frac_kernels(old, new, zeros, rolloff)
    kernels = torch.from_numpy(kernels_np).to(x.device, x.dtype)
    xp = F.pad(x, (width, width + old))
    n_blocks = T // old + 1
    frames = xp.unfold(-1, kernels.shape[-1], old)  # (..., n_blocks, K)
    out = torch.einsum("...bk,pk->...bp", frames, kernels)
    out = out.reshape(*x.shape[:-1], n_blocks * new)
    return out[..., : int(math.ceil(T * new / old))]

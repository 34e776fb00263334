"""Windowed-sinc FIR filters with per-example cutoffs (port of
musicfpaugment_tpu/core/filters.py).

julius builds, per call, a symmetric windowed-sinc kernel of
cutoff-dependent length ``half_size = int(zeros / cutoff / 2)`` (zeros=8),
normalized to unit sum, applied with replicate padding. Here the kernel is
built at a fixed maximum length ``2 * half_size_max + 1`` with the taps
beyond the per-example ``half_size`` masked to zero, so one batched
convolution serves every cutoff in the batch. Window, sinc and the unit sum
are computed in float32, as in the JAX package, so both give the same taps.

Cutoff fractions below ``zeros / (2 * half_size_max)`` get a truncated
kernel (documented divergence of both packages).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from musicfpaugment_torch.core.convolve import fft_convolve
from musicfpaugment_torch.device import cudnn_tf32

DEFAULT_ZEROS = 8.0
DEFAULT_HALF_SIZE_MAX = 4096

# Kernels at or below this tap count run as a direct grouped convolution,
# longer ones as an FFT convolution. The value is the JAX package's, kept so
# that both packages take the same route for the same filter.
DIRECT_CONV_MAX_TAPS = 513


def lowpass_kernels(
    cutoffs: torch.Tensor,
    half_size_max: int = DEFAULT_HALF_SIZE_MAX,
    zeros: float = DEFAULT_ZEROS,
) -> torch.Tensor:
    """julius-compatible low-pass kernels for a (B,) vector of cutoffs given
    as fractions of the sample rate (0.5 is Nyquist).

    Returns (B, 2 * half_size_max + 1) kernels, unit sum, symmetric; rows
    for cutoff <= 0 are all-zero (julius maps cutoff 0 to a zero filter)."""
    cutoffs = torch.atleast_1d(cutoffs).to(torch.float32)[:, None]
    t = torch.arange(
        -half_size_max, half_size_max + 1, dtype=torch.float32, device=cutoffs.device
    )[None, :]
    positive = cutoffs > 0.0
    safe_c = torch.where(positive, cutoffs, 1.0)
    # julius: half_size = int(zeros / cutoff / 2)
    half = torch.floor(zeros / safe_c / 2.0)
    half = torch.clamp(half, 1.0, float(half_size_max))
    inside = t.abs() <= half
    # hann_window(2h+1, periodic=False) re-centered: w(t) = (1+cos(pi t/h))/2
    window = 0.5 * (1.0 + torch.cos(math.pi * t / half))
    arg = 2.0 * safe_c * t * math.pi
    sinc = torch.where(t == 0.0, 1.0, torch.sin(arg) / torch.where(arg == 0.0, 1.0, arg))
    kernel = torch.where(inside, 2.0 * safe_c * window * sinc, 0.0)
    kernel = kernel / kernel.sum(dim=-1, keepdim=True)
    return torch.where(positive, kernel, 0.0)


def _edge_pad(samples: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad the trailing axis (``F.pad`` wants a channel axis)."""
    if samples.ndim == 2:
        return F.pad(samples[:, None, :], (pad, pad), mode="replicate")[:, 0, :]
    return F.pad(samples, (pad, pad), mode="replicate")


def _direct_conv_valid(padded: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """'valid' convolution with a per-example kernel as one grouped
    ``conv1d`` (groups = batch), in full float32: cuDNN stays on and TF32 is
    switched off around the call, since cuDNN convolutions may use it by
    default, and cuDNN's heuristic chooses the engine whatever scope
    encloses the call (the augmenter's output is held exact).

    padded: (B, Tp) or (B, C, Tp); kernels: (B, n). Returns (..., Tp - n + 1).
    """
    k = torch.flip(kernels, dims=[-1])[:, None, :]  # flip: conv, not correlation
    if padded.ndim == 2:
        x = padded[None]  # (1, B, Tp)
        groups = padded.shape[0]
    else:
        b, c, tp = padded.shape
        x = padded.reshape(1, b * c, tp)
        k = k.repeat_interleave(c, dim=0)  # (B*C, 1, n)
        groups = b * c
    with cudnn_tf32(False, benchmark=False):
        y = F.conv1d(x, k, groups=groups)
    return y[0] if padded.ndim == 2 else y.reshape(padded.shape[:-1] + (-1,))


def conv_edge_valid(x: torch.Tensor, kernels: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate-pad by ``pad`` then 'valid' per-example convolution
    (kernels: (B, 2*pad+1)), direct at or below ``DIRECT_CONV_MAX_TAPS`` taps
    and by FFT above."""
    padded = _edge_pad(x, pad)
    if kernels.shape[-1] <= DIRECT_CONV_MAX_TAPS:
        return _direct_conv_valid(padded, kernels)
    kernels = kernels.reshape(kernels.shape[0], *([1] * (x.ndim - 2)), kernels.shape[-1])
    return fft_convolve(padded, kernels, mode="valid")


def lowpass_filter(
    samples: torch.Tensor,
    cutoffs: torch.Tensor,
    half_size_max: int = DEFAULT_HALF_SIZE_MAX,
    zeros: float = DEFAULT_ZEROS,
) -> torch.Tensor:
    """Batched low-pass: ``samples`` (B, T) or (B, C, T), ``cutoffs`` (B,)
    fractions of sr. Matches ``julius.lowpass_filter(x, cutoff, fft=False)``
    applied per example."""
    kernels = lowpass_kernels(cutoffs.to(samples.device), half_size_max, zeros)
    return conv_edge_valid(samples, kernels, half_size_max)


def highpass_filter(
    samples: torch.Tensor,
    cutoffs: torch.Tensor,
    half_size_max: int = DEFAULT_HALF_SIZE_MAX,
    zeros: float = DEFAULT_ZEROS,
) -> torch.Tensor:
    """High-pass as identity minus low-pass."""
    return samples - lowpass_filter(samples, cutoffs, half_size_max, zeros)


def bandpass_filter(
    samples: torch.Tensor,
    low_cutoffs: torch.Tensor,
    high_cutoffs: torch.Tensor,
    half_size_max: int = DEFAULT_HALF_SIZE_MAX,
    zeros: float = DEFAULT_ZEROS,
) -> torch.Tensor:
    """Band-pass = lowpass(high) - lowpass(low), julius' own construction."""
    return lowpass_filter(samples, high_cutoffs, half_size_max, zeros) - lowpass_filter(
        samples, low_cutoffs, half_size_max, zeros
    )


def bandstop_filter(
    samples: torch.Tensor,
    low_cutoffs: torch.Tensor,
    high_cutoffs: torch.Tensor,
    half_size_max: int = DEFAULT_HALF_SIZE_MAX,
    zeros: float = DEFAULT_ZEROS,
) -> torch.Tensor:
    """Band-stop = identity - band-pass."""
    return samples - bandpass_filter(
        samples, low_cutoffs, high_cutoffs, half_size_max, zeros
    )

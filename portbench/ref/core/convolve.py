"""FFT convolution on the trailing axis (port of
musicfpaugment_tpu/core/convolve.py).

Same modes, power-of-two FFT sizes and overlap-save cost model as the JAX
version, so both packages pick the same chunking; the transforms run through
``torch.fft`` (cuFFT on the card, pocketfft on the CPU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _spectral_conv(signal: torch.Tensor, kernel: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Circular convolution at ``fft_size`` on the trailing axis (inputs are
    zero-padded up to fft_size; shorter inputs => linear convolution)."""
    f_signal = torch.fft.rfft(signal, n=fft_size)
    f_kernel = torch.fft.rfft(kernel, n=fft_size)
    return torch.fft.irfft(f_signal * f_kernel, n=fft_size)


def _os_chunk_size(m: int, n: int) -> int:
    """Overlap-save FFT chunk size minimizing total FFT points; the
    single-shot size when chunking does not help."""
    out_len = m + n - 1
    single = next_pow2(out_len)
    best_size = single
    best_cost = 3 * single  # 2 signal passes + 1 kernel pass
    size = next_pow2(2 * n)
    while size < single:
        useful = size - (n - 1)
        chunks = -(-out_len // useful)
        cost = chunks * size * 2 + size
        if cost < best_cost:
            best_cost = cost
            best_size = size
        size *= 2
    return best_size


def _fft_convolve_os(signal: torch.Tensor, kernel: torch.Tensor, chunk: int) -> torch.Tensor:
    """Overlap-save linear convolution, trailing axis; returns 'full'
    length. Each length-``chunk`` circular convolution yields
    ``chunk - (n-1)`` valid outputs."""
    m = signal.shape[-1]
    n = kernel.shape[-1]
    out_len = m + n - 1
    useful = chunk - (n - 1)
    n_chunks = -(-out_len // useful)
    total = (n_chunks - 1) * useful + chunk
    xp = F.pad(signal, (n - 1, max(0, total - (m + n - 1))))
    frames = xp.unfold(-1, chunk, useful)  # (..., n_chunks, chunk)
    seg = _spectral_conv(frames, kernel.unsqueeze(-2), chunk)[..., n - 1 :]
    out = seg.reshape(*seg.shape[:-2], n_chunks * useful)
    return out[..., :out_len]


def fft_convolve(signal: torch.Tensor, kernel: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """1-D convolution of ``signal`` by ``kernel`` via FFT; trailing size
    ``m + n - 1`` ('full'), ``max(m, n) - min(m, n) + 1`` ('valid') or
    ``max(m, n)`` ('same'), truncated from the center."""
    m = signal.shape[-1]
    n = kernel.shape[-1]
    if mode == "full":
        truncate = m + n - 1
    elif mode == "valid":
        truncate = max(m, n) - min(m, n) + 1
    elif mode == "same":
        truncate = max(m, n)
    else:
        raise ValueError(f"Unknown mode: {mode}")

    padded_size = m + n - 1
    single = next_pow2(padded_size)
    chunk = _os_chunk_size(m, n) if n <= m else single
    if chunk < single:
        result = _fft_convolve_os(signal, kernel, chunk)
    else:
        result = _spectral_conv(signal, kernel, single)

    start_idx = (padded_size - truncate) // 2
    return result[..., start_idx : start_idx + truncate]

"""Scalar/array DSP utilities (port of musicfpaugment_tpu/core/utils.py).

All functions operate on the trailing (time) axis, broadcast over leading
batch/channel axes and stay in float32, as the JAX versions do.
"""

from __future__ import annotations

import functools

import torch


class ObjectDict(dict):
    """Attribute-style dict."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value


def is_multichannel(samples: torch.Tensor) -> bool:
    return samples.shape[1] > 1


def calculate_rms(samples: torch.Tensor) -> torch.Tensor:
    """Root-mean-square over the trailing axis."""
    return torch.sqrt(torch.mean(torch.square(samples), dim=-1))


def rms_normalize(samples: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Power-normalize samples."""
    rms = torch.sqrt(torch.mean(torch.square(samples), dim=-1, keepdim=True))
    return samples / (rms + eps)


def peak_normalize(samples: torch.Tensor) -> torch.Tensor:
    """Divide by per-example max-abs; identically-zero signals pass through
    untouched."""
    peak = samples.abs().amax(dim=-1, keepdim=True)
    return torch.where(peak > 0.0, samples / torch.where(peak > 0.0, peak, 1.0), samples)


def convert_decibels_to_amplitude_ratio(decibels: torch.Tensor) -> torch.Tensor:
    """dB -> linear amplitude."""
    return 10.0 ** (decibels / 20.0)


def convert_frequencies_to_mels(f: torch.Tensor) -> torch.Tensor:
    """Hz -> mel, O'Shaughnessy formula."""
    return 2595.0 * torch.log10(1.0 + f / 700.0)


def convert_mels_to_frequencies(m: torch.Tensor) -> torch.Tensor:
    """mel -> Hz."""
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def next_fast_len(size: int) -> int:
    """Next 5-smooth (2/3/5-factor) integer >= size."""
    assert isinstance(size, int) and size > 0
    next_size = size
    while True:
        remaining = next_size
        for n in (2, 3, 5):
            while remaining % n == 0:
                remaining //= n
        if remaining == 1:
            return next_size
        next_size += 1

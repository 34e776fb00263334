"""Colored-noise generation (port of musicfpaugment_tpu/core/noise.py).

White Gaussian noise of one second at ``sample_rate``, shaped in the rfft
domain by ``1 / linspace(1, sqrt(sr/2), nbins) ** f_decay``, RMS-normalized,
tiled to the requested length. The white noise is drawn under a threefry
key as the JAX package's is (one key split per example, a second of
``normal`` under each), on the key's device and then moved to the device
of ``f_decays``, or is handed in as ``white``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from portbench.ref.core import prng
from portbench.ref.core.utils import rms_normalize
from portbench.ref.device import DeviceLike, resolve_device


def white_noise(key: torch.Tensor, batch: int, sample_rate: int) -> torch.Tensor:
    """(batch, sample_rate) float32 normals: ``key`` split into one key per
    example (a (batch, 2) batch of keys: each split into one), a second of
    noise under each."""
    key = prng.as_key(key)
    keys = prng.split(key, batch if key.ndim == 1 else 1)
    return prng.normal(keys, (sample_rate,)).reshape(batch, sample_rate)


def batch_colored_noise(
    key: Optional[torch.Tensor],
    f_decays: torch.Tensor,
    num_samples: int,
    sample_rate: int = 44100,
    white: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B,) f_decays -> (B, num_samples) noise with a 1/f**f_decay spectrum,
    on the device of ``f_decays``; ``key`` is unused when ``white`` is
    given."""
    f_decays = f_decays.to(torch.float32)
    if white is None:
        white = white_noise(key, f_decays.shape[0], sample_rate)
    white = white.to(f_decays.device)
    spec = torch.fft.rfft(white)
    ramp = torch.linspace(
        1.0, (sample_rate / 2.0) ** 0.5, spec.shape[-1], device=f_decays.device
    )
    mask = 1.0 / ramp[None, :] ** f_decays[:, None]
    noise = rms_normalize(torch.fft.irfft(spec * mask, n=sample_rate))
    reps = int(math.ceil(num_samples / sample_rate))
    return noise.repeat(1, reps)[:, :num_samples]


def gen_colored_noise(
    key: torch.Tensor,
    f_decay: float,
    num_samples: int,
    sample_rate: int = 44100,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(num_samples,) colored noise with a 1/f**f_decay spectrum, on
    ``device`` (``None`` is CUDA)."""
    f = torch.as_tensor([f_decay], dtype=torch.float32, device=resolve_device(device))
    white = prng.normal(prng.as_key(key), (sample_rate,))[None]
    return batch_colored_noise(None, f, num_samples, sample_rate, white=white)[0]

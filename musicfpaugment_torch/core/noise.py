"""Colored-noise generation (port of musicfpaugment_tpu/core/noise.py).

White Gaussian noise of one second at ``sample_rate``, shaped in the rfft
domain by ``1 / linspace(1, sqrt(sr/2), nbins) ** f_decay``, RMS-normalized,
tiled to the requested length. The white noise comes from an explicit CPU
``torch.Generator`` (then moved to the device of ``f_decays``), or is handed
in as ``white``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from musicfpaugment_torch.core.utils import rms_normalize
from musicfpaugment_torch.device import DeviceLike, resolve_device


def batch_colored_noise(
    generator: Optional[torch.Generator],
    f_decays: torch.Tensor,
    num_samples: int,
    sample_rate: int = 44100,
    white: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B,) f_decays -> (B, num_samples) noise with a 1/f**f_decay spectrum,
    on the device of ``f_decays``."""
    f_decays = f_decays.to(torch.float32)
    if white is None:
        white = torch.randn(
            (f_decays.shape[0], sample_rate), generator=generator, dtype=torch.float32
        )
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
    generator: Optional[torch.Generator],
    f_decay: float,
    num_samples: int,
    sample_rate: int = 44100,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(num_samples,) colored noise with a 1/f**f_decay spectrum, on
    ``device`` (``None`` is CUDA)."""
    f = torch.as_tensor([f_decay], dtype=torch.float32, device=resolve_device(device))
    return batch_colored_noise(generator, f, num_samples, sample_rate)[0]

"""The denoiser kinds that the fingerprinters take in front of their peaks,
by what their hook maps: a spectrogram kind's hook the normalised magnitude
(``spec_denoiser``), a waveform kind's the waveforms (``wave_denoiser``)."""

from __future__ import annotations

from typing import Sequence

SPECTROGRAM_DENOISERS = ("unet",)
WAVEFORM_DENOISERS = ("demucs", "htdemucs", "bs_roformer")
# every kind, in audfprint's order of naming them; Dejavu names the
# spectrogram kind first
DENOISING_MODELS = ("demucs", "unet", "htdemucs", "bs_roformer")
DEJAVU_ORDER = SPECTROGRAM_DENOISERS + WAVEFORM_DENOISERS


def check_denoising_model(denoising_model, named: Sequence[str] = DENOISING_MODELS) -> None:
    """Raise unless ``denoising_model`` is a known kind; the message names
    the kinds in the order of ``named``."""
    if denoising_model not in named:
        raise ValueError(f"denoising_model must be {' or '.join(map(repr, named))}, "
                         f"not {denoising_model!r}")

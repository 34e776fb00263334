"""AugmentFP engine: batched music degradation in PyTorch, on the card."""

from musicfpaugment_torch.augment.banks import (
    IRBank,
    NoiseBank,
    build_ir_bank,
    build_noise_bank,
)
from musicfpaugment_torch.augment.compose import BaseCompose, Compose, OneOf, SomeOf
from musicfpaugment_torch.augment.constants import (
    DEFAULT_PARAMETERS,
    IMPULSE_RESPONSE_DIR,
    WAVEFORM_SAMPLING_RATE,
)
from musicfpaugment_torch.augment.pipeline import AugmentFP, dcase_shaped_banks, synthetic_banks
from musicfpaugment_torch.augment.transforms import (
    AddBackgroundNoise,
    AddColoredNoise,
    ApplyImpulseResponse,
    BandPassFilter,
    BandStopFilter,
    BaseWaveformTransform,
    Clipping,
    Gain,
    HighPassFilter,
    LowPassFilter,
    PeakNormalization,
)

__all__ = [
    "AugmentFP",
    "synthetic_banks",
    "dcase_shaped_banks",
    "IRBank",
    "NoiseBank",
    "build_ir_bank",
    "build_noise_bank",
    "BaseCompose",
    "Compose",
    "OneOf",
    "SomeOf",
    "DEFAULT_PARAMETERS",
    "IMPULSE_RESPONSE_DIR",
    "WAVEFORM_SAMPLING_RATE",
    "AddBackgroundNoise",
    "AddColoredNoise",
    "ApplyImpulseResponse",
    "BandPassFilter",
    "BandStopFilter",
    "BaseWaveformTransform",
    "Clipping",
    "Gain",
    "HighPassFilter",
    "LowPassFilter",
    "PeakNormalization",
]

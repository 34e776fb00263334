"""Training: losses, the CQT losses, the trainer, the CLI (``train.train``)."""

from musicfpaugment_torch.train.cqt import (
    cqt_loss,
    cqt_magnitude,
    multi_resolution_cqt_loss,
)
from musicfpaugment_torch.train.losses import (
    l1_loss,
    log_stft_magnitude_loss,
    multi_resolution_stft_loss,
    psnr,
    spectral_convergence_loss,
    stft_loss,
    stft_magnitude,
)
from musicfpaugment_torch.train.trainer import (
    EarlyStopping,
    ReduceLROnPlateau,
    Trainer,
    spectrogram_batch,
)

__all__ = [
    "cqt_loss",
    "cqt_magnitude",
    "multi_resolution_cqt_loss",
    "l1_loss",
    "log_stft_magnitude_loss",
    "multi_resolution_stft_loss",
    "psnr",
    "spectral_convergence_loss",
    "stft_loss",
    "stft_magnitude",
    "EarlyStopping",
    "ReduceLROnPlateau",
    "Trainer",
    "spectrogram_batch",
]

"""Denoiser models: the UNet spectrogram denoiser and the Demucs waveform
denoiser."""

from musicfpaugment_torch.models.demucs import BLSTM, Demucs, rescale_params
from musicfpaugment_torch.models.unet import DoubleConv, Down, UNet, Up

__all__ = ["UNet", "DoubleConv", "Down", "Up", "Demucs", "BLSTM", "rescale_params"]

"""Denoiser models: the UNet spectrogram denoiser and the Demucs waveform
denoiser, and Flax's starting weights for both."""

from musicfpaugment_torch.models.demucs import BLSTM, Demucs, rescale_params
from musicfpaugment_torch.models.flax_init import flax_init
from musicfpaugment_torch.models.unet import DoubleConv, Down, UNet, Up

__all__ = ["UNet", "DoubleConv", "Down", "Up", "Demucs", "BLSTM", "flax_init", "rescale_params"]

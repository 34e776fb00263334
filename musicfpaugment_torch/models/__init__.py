"""Denoiser models: the UNet spectrogram denoiser."""

from musicfpaugment_torch.models.unet import DoubleConv, Down, UNet, Up

__all__ = ["UNet", "DoubleConv", "Down", "Up"]

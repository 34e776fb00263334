"""Denoiser models: the UNet spectrogram denoiser, the Demucs, Hybrid
Transformer Demucs and Band-Split RoPE Transformer waveform denoisers, and
Flax's starting weights for the UNet and Demucs."""

from musicfpaugment_torch.models.bs_roformer import BSRoformer
from musicfpaugment_torch.models.demucs import BLSTM, Demucs, rescale_params
from musicfpaugment_torch.models.flax_init import flax_init
from musicfpaugment_torch.models.htdemucs import HTDemucs
from musicfpaugment_torch.models.unet import DoubleConv, Down, UNet, Up

__all__ = ["UNet", "DoubleConv", "Down", "Up", "Demucs", "BLSTM", "HTDemucs", "BSRoformer",
           "flax_init", "rescale_params"]

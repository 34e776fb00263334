"""Training: so far the PSNR that the evaluation metrics read."""

from musicfpaugment_torch.train.losses import psnr

__all__ = ["psnr"]

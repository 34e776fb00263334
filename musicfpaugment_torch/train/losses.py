"""Losses and scores (port of musicfpaugment_tpu/train/losses.py): so far
``psnr`` only; the training losses come with the trainer."""

from __future__ import annotations

import torch


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB, micro-averaged over the whole
    tensors, the data range taken from the two tensors themselves
    (torchmetrics' ``PeakSignalNoiseRatio(average="micro")``)."""
    data_range = torch.maximum(pred, target).max() - torch.minimum(pred, target).min()
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))

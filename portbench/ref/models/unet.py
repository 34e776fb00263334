"""UNet magnitude-spectrogram denoiser (port of
musicfpaugment_tpu/models/unet.py).

4-down / 4-up UNet, ``base`` -> 16 * ``base`` channels, DoubleConv = 2 x
[3x3 conv (no bias) + BatchNorm + ReLU], 2x2 max-pool down, 2x2 stride-2
transposed conv (or bilinear resize) up, skip concat with the odd-size pad
fix, 1x1 output conv, dropout on the inner levels (Flax's draws:
``models/dropout.py``). The layout is NCHW with
H = frequency and W = time, the spatial order of the JAX model's NHWC;
inputs are (batch, freq, time) magnitude spectrograms, the channel axis is
added inside. ``eval()`` is the JAX model's ``train=False``, ``train()`` its
``train=True``; a training forward at ``rate > 0`` takes the step's dropout
key (the JAX model's ``rngs={"dropout": key}``). The layers are
``torch.nn`` modules (cuDNN on the card) but for the dropout, a kernel of
this port on the card: the JAX model's are XLA convolutions, it reaches no
Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from portbench.ref.device import cudnn_tf32
from portbench.ref.models.dropout import FlaxDropout

__all__ = ["FlaxBatchNorm2d", "DoubleConv", "Down", "Up", "UNet", "cudnn_tf32"]


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``BatchNorm2d`` that keeps Flax's running statistics: a training
    forward folds the *biased* batch variance into ``running_var`` (PyTorch
    folds in the unbiased one). The outputs are ``BatchNorm2d``'s in both
    modes. ``momentum`` is PyTorch's: 0.1 is Flax's 0.9.

    With ``distributed`` set (the trainer sets it when it trains under
    ``DistributedDataParallel`` on more than one rank), a training forward
    normalises by the
    statistics of the *global* batch, every rank's slice together, as Flax's
    BatchNorm does under JAX's sharding: the per-channel sums, then the sums
    of squared deviations from the global mean, go through the
    process group's autograd-aware all-reduce (two-pass, so the variance is
    as exact as one process's)."""

    distributed = False

    def _global_stats(self, x: torch.Tensor):
        import torch.distributed.nn.functional as dist_nn

        n = torch.full((1,), x.numel() // x.shape[1], dtype=x.dtype, device=x.device)
        packed = dist_nn.all_reduce(torch.cat([x.sum(dim=(0, 2, 3)), n]))
        count = packed[-1]
        mean = packed[:-1] / count
        d = x - mean[None, :, None, None]
        var = dist_nn.all_reduce((d * d).sum(dim=(0, 2, 3))) / count
        return d, mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.distributed:
            xs = x.to(torch.promote_types(x.dtype, self.running_mean.dtype))
            d, mean, var = self._global_stats(xs)
            with torch.no_grad():
                self.running_mean.lerp_(mean.detach().to(self.running_mean.dtype), self.momentum)
                self.running_var.lerp_(var.detach().to(self.running_var.dtype), self.momentum)
                self.num_batches_tracked += 1
            shape = (1, -1, 1, 1)
            y = d * torch.rsqrt(var + self.eps).reshape(shape) * self.weight.reshape(shape)
            return (y + self.bias.reshape(shape)).to(x.dtype)
        with torch.no_grad():
            stats_in = x.detach().to(self.running_mean.dtype)
            var, mean = torch.var_mean(stats_in, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class DoubleConv(nn.Module):
    """(conv 3x3 -> BN -> ReLU) * 2."""

    def __init__(self, in_channels: int, out_channels: int, mid_channels: Optional[int] = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.conv1 = nn.Conv2d(in_channels, mid, 3, padding=1, bias=False)
        self.bn1 = FlaxBatchNorm2d(mid, eps=1e-5, momentum=0.1)
        self.conv2 = nn.Conv2d(mid, out_channels, 3, padding=1, bias=False)
        self.bn2 = FlaxBatchNorm2d(out_channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class Down(nn.Module):
    """max-pool 2x2 (odd sizes floored) then DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.max_pool2d(x, 2))


class Up(nn.Module):
    """Upscale the deep input (``deep_channels``), pad it to the skip's size,
    concat [skip, upsampled], DoubleConv. The transposed conv halves the deep
    input's channels; the bilinear resize keeps them and the DoubleConv's
    middle width is half of them."""

    def __init__(self, deep_channels: int, skip_channels: int, out_channels: int,
                 bilinear: bool = False):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(skip_channels + deep_channels, out_channels, deep_channels // 2)
        else:
            self.up = nn.ConvTranspose2d(deep_channels, deep_channels // 2, 2, stride=2)
            self.conv = DoubleConv(skip_channels + deep_channels // 2, out_channels)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.bilinear:
            # half-pixel centres, as jax.image.resize(..., "bilinear")
            x1 = F.interpolate(x1, scale_factor=2, mode="bilinear", align_corners=False)
        else:
            x1 = self.up(x1)
        diff_h = x2.shape[2] - x1.shape[2]
        diff_w = x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, (diff_w // 2, diff_w - diff_w // 2, diff_h // 2, diff_h - diff_h // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class UNet(nn.Module):
    """``rate`` is the dropout rate (0.05 in training). ``dtype`` is the
    compute dtype of the body (``torch.bfloat16`` for mixed precision, by
    autocast): parameters stay float32, and the last 1x1 conv and the output
    are float32 whatever it is. With ``dtype=None`` the convolutions run in
    full float32 (TF32 off around the forward)."""

    def __init__(
        self,
        n_channels: int = 1,
        n_classes: int = 1,
        rate: float = 0.0,
        bilinear: bool = False,
        base: int = 64,  # width scale; 64 = the reference channel plan
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        super().__init__()
        self.n_channels, self.n_classes = n_channels, n_classes
        self.rate, self.bilinear, self.base, self.dtype = rate, bilinear, base, dtype
        factor = 2 if bilinear else 1
        b = base
        self.inc = DoubleConv(n_channels, b)
        self.down1 = Down(b, 2 * b)
        self.down2 = Down(2 * b, 4 * b)
        self.down3 = Down(4 * b, 8 * b)
        self.down4 = Down(8 * b, 16 * b // factor)
        self.up1 = Up(16 * b // factor, 8 * b, 8 * b // factor, bilinear)
        self.up2 = Up(8 * b // factor, 4 * b, 4 * b // factor, bilinear)
        self.up3 = Up(4 * b // factor, 2 * b, 2 * b // factor, bilinear)
        self.up4 = Up(2 * b // factor, b, b, bilinear)
        self.outc = nn.Conv2d(b, n_classes, 1)
        # Flax's Dropout_0 .. Dropout_4, in call order
        self.dropouts = nn.ModuleList(FlaxDropout(rate, i) for i in range(5))

    def body(self, x: torch.Tensor, dropout_key: Optional[torch.Tensor] = None,
             batch_offset: int = 0) -> torch.Tensor:
        """(B, n_channels, F, T) -> (B, base, F, T), everything before the
        1x1 output conv, under whatever precision context the caller set."""
        def drop(i: int, h: torch.Tensor) -> torch.Tensor:
            return self.dropouts[i](h, dropout_key, batch_offset)

        x1 = self.inc(x)
        x2 = drop(0, self.down1(x1))
        x3 = drop(1, self.down2(x2))
        x4 = drop(2, self.down3(x3))
        x5 = drop(3, self.down4(x4))
        h = drop(4, self.up1(x5, x4))
        h = self.up2(h, x3)
        h = self.up3(h, x2)
        return self.up4(h, x1)

    def forward(self, x: torch.Tensor, dropout_key: Optional[torch.Tensor] = None,
                batch_offset: int = 0) -> torch.Tensor:
        """x: (batch, freq, time) or (batch, channels, freq, time).
        ``dropout_key``: the dropout key of a training forward (required at
        ``rate > 0``); ``batch_offset``: the index of ``x``'s first example
        in the global batch whose mask the key draws (a rank's slice)."""
        squeeze_channel = x.ndim == 3
        if squeeze_channel:
            x = x[:, None]
        if self.dtype is None:
            with cudnn_tf32(False):
                logits = self.outc(self.body(x, dropout_key, batch_offset))
        else:
            with torch.autocast(x.device.type, dtype=self.dtype):
                h = self.body(x, dropout_key, batch_offset)
            with cudnn_tf32(False), torch.autocast(x.device.type, enabled=False):
                logits = self.outc(h.float())
        if squeeze_channel and self.n_classes == 1:
            logits = logits[:, 0]
        return logits

"""Demucs waveform denoiser (port of musicfpaugment_tpu/models/demucs.py).

The reference's architecture and module layout: ``encoder[i]`` is
``Sequential(Conv1d(k=8, s=4), ReLU, Conv1d(1x1), GLU(1))``, ``decoder[j]``
(deepest first) is ``Sequential(Conv1d(1x1), GLU(1), ConvTranspose1d(k=8,
s=4)[, ReLU])``, and ``lstm`` a 2-layer LSTM bottleneck, causal or
bidirectional with a linear layer after it. Inputs are normalised by the
std of their mono mix (with ``floor``), padded to :meth:`Demucs.valid_length`,
sinc-upsampled x2 or x4 (``core/resample.py``) before the encoder and
downsampled after the decoder, trimmed to their length and scaled back.
The layers are ``torch.nn`` modules (cuDNN on the card): the JAX model's are
XLA convolutions and LSTM cells, it reaches no Pallas kernel.

A fresh model holds PyTorch's default initialisation;
``models.flax_init`` gives it the JAX package's (Flax's initialisers under
``PRNGKey(0)``), and :func:`rescale_params` is the reference's rescale,
which the trainer applies after it as the JAX trainer does.
``convert.demucs_state_dict_from_flax`` carries Flax weights across.

The JAX model's ``fused_frontend`` (the x4 resampling folded into the first
and last convolutions through phase bases) is a layout for the TPU's
matrix unit, equal to the unfused model within 2e-5 on the same weights and
not offered by the JAX CLI: it is not ported.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from portbench.ref.core.resample import downsample2, upsample2
from portbench.ref.device import cudnn_tf32

STOP_AT = ("frontend", "enc1", "enc", "lstm", "dec")


class BLSTM(nn.Module):
    """``nn.LSTM(dim, dim, num_layers=layers, batch_first=True,
    bidirectional=bi)``, then ``nn.Linear(2 * dim, dim)`` when ``bi``."""

    def __init__(self, dim: int, layers: int = 2, bi: bool = True) -> None:
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers=layers, batch_first=True, bidirectional=bi)
        self.linear = nn.Linear(2 * dim, dim) if bi else None

    def forward(
        self, x: torch.Tensor, hidden: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x: (batch, time, dim) -> ((batch, time, dim), (h, c)). The LSTM
        and the linear layer compute in ``x``'s dtype (the float32
        parameters cast to it, gradients flowing back through the cast)."""
        if x.dtype == self.lstm.weight_ih_l0.dtype:
            y, hidden = self.lstm(x, hidden)
        else:
            cast = {name: p.to(x.dtype) for name, p in self.lstm.named_parameters()}
            y, hidden = torch.func.functional_call(self.lstm, cast, (x, hidden))
        if self.linear is not None:
            y = F.linear(y, self.linear.weight.to(y.dtype), self.linear.bias.to(y.dtype))
        return y, hidden


class Demucs(nn.Module):
    """Defaults are the published model: hidden 48, depth 5, kernel 8,
    stride 4, causal LSTM, x4 resampling, GLU, growth 2: 18,867,937
    parameters at one channel in and out, 18,861,793 in the JAX layout,
    whose LSTM cells carry one bias per gate where ``nn.LSTM`` carries two.

    ``dtype`` is the compute dtype of the encoder, the LSTM and the decoder
    (``torch.bfloat16`` for mixed precision): the sinc resampling, the
    parameters and the output stay float32. With ``dtype=None`` everything
    runs in strict float32 (cuDNN's TF32 off, for the convolutions and the
    cuDNN LSTM)."""

    def __init__(
        self,
        chin: int = 1,
        chout: int = 1,
        hidden: int = 48,
        depth: int = 5,
        kernel_size: int = 8,
        stride: int = 4,
        causal: bool = True,
        resample: int = 4,
        growth: int = 2,
        max_hidden: int = 10_000,
        normalize: bool = True,
        glu: bool = True,
        floor: float = 1e-3,
        sample_rate: int = 8000,
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        super().__init__()
        if resample not in (1, 2, 4):
            raise ValueError(f"resample must be 1, 2 or 4, not {resample}")
        self.chin, self.chout, self.hidden, self.depth = chin, chout, hidden, depth
        self.kernel_size, self.stride, self.causal = kernel_size, stride, causal
        self.resample, self.growth, self.max_hidden = resample, growth, max_hidden
        self.normalize, self.glu, self.floor = normalize, glu, floor
        self.sample_rate, self.dtype = sample_rate, dtype
        ch_scale = 2 if glu else 1
        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()

        def act():
            return nn.GLU(1) if glu else nn.ReLU()

        for chin_i, chout_i, hidden_i in self.channel_plan():
            self.encoder.append(nn.Sequential(
                nn.Conv1d(chin_i, hidden_i, kernel_size, stride), nn.ReLU(),
                nn.Conv1d(hidden_i, hidden_i * ch_scale, 1), act(),
            ))
            decode = [nn.Conv1d(hidden_i, ch_scale * hidden_i, 1), act(),
                      nn.ConvTranspose1d(hidden_i, chout_i, kernel_size, stride)]
            if self.decoder:  # ReLU on all but the output decode
                decode.append(nn.ReLU())
            self.decoder.insert(0, nn.Sequential(*decode))
        self.lstm = BLSTM(self.channel_plan()[-1][2], bi=not causal)

    def channel_plan(self):
        """(chin, chout, hidden) of each encoder stage."""
        chin, chout, hidden = self.chin, self.chout, self.hidden
        plan = []
        for _ in range(self.depth):
            plan.append((chin, chout, hidden))
            chout = hidden
            chin = hidden
            hidden = min(int(self.growth * hidden), self.max_hidden)
        return plan

    def valid_length(self, length: int) -> int:
        """The nearest input length at or above ``length`` for which every
        convolution sees whole windows."""
        length = math.ceil(length * self.resample)
        for _ in range(self.depth):
            length = math.ceil((length - self.kernel_size) / self.stride) + 1
            length = max(length, 1)
        for _ in range(self.depth):
            length = (length - 1) * self.stride + self.kernel_size
        return int(math.ceil(length / self.resample))

    @property
    def total_stride(self) -> int:
        return self.stride**self.depth // self.resample

    def forward(self, mix: torch.Tensor, stop_at: Optional[str] = None) -> torch.Tensor:
        """mix: (batch, time) or (batch, channels, time) -> the same shape.

        ``stop_at`` returns the (batch, channels, time) activation after a
        milestone, for stage timing: ``frontend`` (normalised, padded,
        resampled), ``enc1`` (the first encoder stage), ``enc`` (all of
        them), ``lstm``, ``dec`` (the decoder, before the downsampling)."""
        if stop_at is not None and stop_at not in STOP_AT:
            raise ValueError(f"stop_at must be one of {STOP_AT}, not {stop_at!r}")
        with cudnn_tf32(False):
            return self._forward(mix, stop_at)

    def _forward(self, mix: torch.Tensor, stop_at: Optional[str]) -> torch.Tensor:
        squeeze_channel = mix.ndim == 2
        if squeeze_channel:
            mix = mix[:, None, :]
        if self.normalize:
            mono = mix.mean(dim=1, keepdim=True)
            std = mono.std(dim=-1, keepdim=True, correction=0)
            mix = mix / (self.floor + std)
        else:
            std = 1.0
        length = mix.shape[-1]
        x = F.pad(mix, (0, self.valid_length(length) - length))
        if self.resample == 2:
            x = upsample2(x)
        elif self.resample == 4:
            x = upsample2(upsample2(x))
        if stop_at == "frontend":
            return x

        autocast = torch.autocast(x.device.type, dtype=self.dtype or torch.bfloat16,
                                  enabled=self.dtype is not None)
        skips = []
        with autocast:
            for i, encode in enumerate(self.encoder):
                x = encode(x)
                skips.append(x)
                if i == 0 and stop_at == "enc1":
                    return x
        if stop_at == "enc":
            return x
        # outside autocast: the LSTM computes in the dtype it is given
        x = self.lstm(x.transpose(1, 2).to(self.dtype or x.dtype))[0].transpose(1, 2)
        if stop_at == "lstm":
            return x
        with autocast:
            for decode in self.decoder:
                skip = skips.pop(-1)
                x = decode(x + skip[..., : x.shape[-1]])
        if stop_at == "dec":
            return x

        x = x.to(mix.dtype)
        if self.resample == 2:
            x = downsample2(x)
        elif self.resample == 4:
            x = downsample2(downsample2(x))
        out = std * x[..., :length]
        return out[:, 0, :] if squeeze_channel else out


@torch.no_grad()
def rescale_params(model: nn.Module, reference: float = 0.1, eps: float = 1e-12) -> nn.Module:
    """The reference's weight rescale, in place: every ``Conv1d`` and
    ``ConvTranspose1d`` has its weight and bias divided by
    ``sqrt(std(weight) / reference + eps)`` (the population std over all of
    the weight's elements). The LSTM and the linear layer are left as they
    are. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            scale = torch.sqrt(m.weight.std(correction=0) / reference + eps)
            m.weight.div_(scale)
            if m.bias is not None:
                m.bias.div_(scale)
    return model

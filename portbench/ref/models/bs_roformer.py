"""Band-Split RoPE Transformer (BS-RoFormer) in plain PyTorch: the reference
that the program's ``models/bs_roformer.py`` is held to.

Lu, Wang, Kong, Hung, "Music Source Separation with Band-Split RoPE
Transformer", ICASSP 2024 (arXiv:2309.02612); the ``BSRoformer`` class of
``bs_roformer/bs_roformer.py`` in github.com/lucidrains/BS-RoFormer and the
rotary embedding of ``rotary_embedding_torch`` (``freqs_for="lang"``, theta
10,000). Module and parameter names are the published ones, so one state
dict loads here and in the program.

The forward: the STFT (Hann window, centred, not normalised), each bin's
(real, imaginary) pair side by side, cut into bands of ``2 x bins`` values;
each band through an RMSNorm and a linear layer to a token of width ``dim``;
``depth`` axial blocks, each a Transformer along the frames (every band on
its own, RoPE on frame indices) and one across the bands (every frame on its
own, RoPE on band indices), a layer being ``x = attn(x) + x; x = ff(x) +
x`` with pre-RMSNorm attention and a pre-RMSNorm GELU feed-forward of four
times the width; a last RMSNorm; each band's MLP (linear, Tanh, linear to
twice the band's values, GLU) giving its complex mask; the mask times the
STFT; the iSTFT, cropped to the input's length.

This file imports only ``torch``. Written out here, where the program calls
library functions: the RMSNorm (``x / max(|x|, 1e-12) * sqrt(dim) *
gamma``); attention as softmax(Q K^T / sqrt(dim_head)) V; RoPE as the turn
of each channel pair (2 i, 2 i + 1) by ``pos * 10000^(-2 i / dim_head)``;
the complex product of mask and STFT in real arithmetic; the iSTFT
(``torch.fft.irfft``, the window, overlap-add frame by frame and division by
the window's squared envelope, as ``torch.istft`` with ``center=True``
does), so that the model also runs on the meta device, where
``torch.istft`` does not.

Departures from the published code: one audio channel (``stereo=False``),
one stem, no linear-attention layers, no per-head output gates
(``to_gates``, in later versions of the public code and not in the paper),
evaluation only (no dropout), the STFT not normalised; the RoPE frequencies
are computed, not kept as state; the iSTFT is cropped to the input's length.
A (B, N) input gives (B, N). Everything runs in float32 with cuDNN's and
cuBLAS's TF32 switches off (``tf32_switches(False)``, restored after the
forward).
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
from torch import nn

DEFAULT_FREQS_PER_BANDS = ((2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8
                           + (128, 129))
UNSUPPORTED = {"stereo": False, "num_stems": 1, "linear_transformer_depth": 0,
               "attn_dropout": 0.0, "ff_dropout": 0.0, "stft_normalized": False}


@contextlib.contextmanager
def tf32_switches(allow: bool):
    """cuDNN's and cuBLAS's TF32 switches set to ``allow`` inside the block
    and restored after; the other cuDNN flags stay as they are."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = allow
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=allow):
            yield
    finally:
        matmul.allow_tf32 = before


class RMSNorm(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.dim = dim
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True)).clamp_min(1e-12)
        return x / norm * math.sqrt(self.dim) * self.gamma


def rope(x: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """(..., n, d) turned pair by pair: channels (2 i, 2 i + 1) of position
    ``p`` by the angle ``p * theta^(-2 i / d)``."""
    n, d = x.shape[-2:]
    i = torch.arange(d // 2, device=x.device, dtype=x.dtype)
    pos = torch.arange(n, device=x.device, dtype=x.dtype)
    angle = pos[:, None] * (1.0 / theta ** (2 * i / d))[None, :]  # (n, d / 2)
    cos, sin = torch.cos(angle), torch.sin(angle)
    even, odd = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = even * cos - odd * sin
    out[..., 1::2] = odd * cos + even * sin
    return out


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int) -> None:
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads * dim_head, dim, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        S, n, _ = x.shape
        H, d = self.heads, self.dim_head
        qkv = self.to_qkv(self.norm(x)).reshape(S, n, 3, H, d)
        q, k, v = (qkv[:, :, j].permute(0, 2, 1, 3) for j in range(3))  # (S, H, n, d)
        q, k = rope(q), rope(k)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.to_out(out.permute(0, 2, 1, 3).reshape(S, n, H * d))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4) -> None:
        super().__init__()
        # the published Sequential's indices: 2 the GELU, 3 and 5 dropouts
        self.net = nn.Sequential(RMSNorm(dim), nn.Linear(dim, dim * mult), nn.GELU(),
                                 nn.Identity(), nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.net[1](self.net[0](x))
        h = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))  # exact GELU
        return self.net[4](h)


class Transformer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, dim_head: int) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, heads, dim_head), FeedForward(dim)]) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return x


class BandSplit(nn.Module):
    def __init__(self, dim: int, dim_inputs: Sequence[int]) -> None:
        super().__init__()
        self.dim_inputs = tuple(dim_inputs)
        self.to_features = nn.ModuleList(nn.Sequential(RMSNorm(d), nn.Linear(d, dim))
                                         for d in self.dim_inputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs, at = [], 0
        for d, net in zip(self.dim_inputs, self.to_features):
            outs.append(net(x[..., at:at + d]))
            at += d
        return torch.stack(outs, dim=-2)


class MaskEstimator(nn.Module):
    def __init__(self, dim: int, dim_inputs: Sequence[int], depth: int,
                 mlp_expansion_factor: int = 4) -> None:
        super().__init__()
        hidden = dim * mlp_expansion_factor
        self.to_freqs = nn.ModuleList()
        for d in dim_inputs:
            dims = (dim,) + (hidden,) * (depth - 1) + (2 * d,)
            layers = []
            for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                layers.append(nn.Linear(a, b))
                if j < len(dims) - 2:
                    layers.append(nn.Tanh())
            self.to_freqs.append(nn.Sequential(nn.Sequential(*layers)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for b, net in enumerate(self.to_freqs):
            y = net[0](x[..., b, :])
            half = y.shape[-1] // 2
            outs.append(y[..., :half] * torch.sigmoid(y[..., half:]))  # GLU
        return torch.cat(outs, dim=-1)


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
          length: int) -> torch.Tensor:
    """``torch.istft(re + i im, n_fft, hop, window=window, center=True,
    normalized=False, length=length)`` for (B, bins, T) parts, written out."""
    B, _, T = re.shape
    frames = torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-2) * window[:, None]
    total = n_fft + hop * (T - 1)
    out = re.new_zeros(B, total)
    env = re.new_zeros(total)
    wsq = window * window
    for t in range(T):
        out[:, t * hop:t * hop + n_fft] += frames[:, :, t]
        env[t * hop:t * hop + n_fft] += wsq
    start = n_fft // 2
    out = out[:, start:start + length] / env[start:start + length]
    # past the last frame: zeros, as torch.istft pads
    return torch.nn.functional.pad(out, (0, length - out.shape[-1]))


class BSRoformer(nn.Module):
    def __init__(self, dim: int, depth: int, stereo: bool = False, num_stems: int = 1,
                 time_transformer_depth: int = 2, freq_transformer_depth: int = 2,
                 linear_transformer_depth: int = 0,
                 freqs_per_bands: Sequence[int] = DEFAULT_FREQS_PER_BANDS, dim_head: int = 64,
                 heads: int = 8, attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 stft_n_fft: int = 2048, stft_hop_length: int = 512, stft_win_length: int = 2048,
                 stft_normalized: bool = False, mask_estimator_depth: int = 2,
                 mlp_expansion_factor: int = 4) -> None:
        super().__init__()
        given = {"stereo": stereo, "num_stems": num_stems,
                 "linear_transformer_depth": linear_transformer_depth,
                 "attn_dropout": attn_dropout, "ff_dropout": ff_dropout,
                 "stft_normalized": stft_normalized}
        for key, value in given.items():
            if value != UNSUPPORTED[key]:
                raise ValueError(f"{key}={value!r} is not implemented")
        freqs_per_bands = tuple(int(f) for f in freqs_per_bands)
        if sum(freqs_per_bands) != stft_n_fft // 2 + 1:
            raise ValueError(f"the bands cover {sum(freqs_per_bands)} bins, not "
                             f"{stft_n_fft // 2 + 1}")
        self.n_fft, self.hop, self.win_length = stft_n_fft, stft_hop_length, stft_win_length
        self.layers = nn.ModuleList(
            nn.ModuleList([Transformer(dim, time_transformer_depth, heads, dim_head),
                           Transformer(dim, freq_transformer_depth, heads, dim_head)])
            for _ in range(depth))
        self.final_norm = RMSNorm(dim)
        dim_inputs = tuple(2 * f for f in freqs_per_bands)
        self.band_split = BandSplit(dim, dim_inputs)
        self.mask_estimators = nn.ModuleList(
            [MaskEstimator(dim, dim_inputs, mask_estimator_depth, mlp_expansion_factor)])

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """(B, N) -> (B, N)."""
        with tf32_switches(False):
            B, N = mix.shape
            window = torch.hann_window(self.win_length, device=mix.device, dtype=mix.dtype)
            z = torch.stft(mix, self.n_fft, self.hop, win_length=self.win_length, window=window,
                           center=True, normalized=False, return_complex=True)
            spec = torch.view_as_real(z)  # (B, bins, T, 2)
            T = spec.shape[2]
            x = spec.permute(0, 2, 1, 3).reshape(B, T, -1)  # b t (f c)
            x = self.band_split(x)  # (B, T, K, D)
            K, D = x.shape[-2:]
            for time_transformer, freq_transformer in self.layers:
                x = x.permute(0, 2, 1, 3).reshape(B * K, T, D)
                x = time_transformer(x)
                x = x.reshape(B, K, T, D).permute(0, 2, 1, 3).reshape(B * T, K, D)
                x = freq_transformer(x)
                x = x.reshape(B, T, K, D)
            mask = self.mask_estimators[0](self.final_norm(x))  # b t (f c)
            mask = mask.reshape(B, T, -1, 2).permute(0, 2, 1, 3)  # (B, bins, T, 2)
            a, b = spec[..., 0], spec[..., 1]
            c, d = mask[..., 0], mask[..., 1]
            return istft(a * c - b * d, a * d + b * c, self.n_fft, self.hop, window, N)

"""Hybrid Transformer Demucs (HTDemucs) in plain PyTorch: the reference that
the program's ``models/htdemucs.py`` is held to.

Rouard, Massa, Défossez, "Hybrid Transformers for Music Source
Separation", ICASSP 2023 (arXiv:2211.08553); the ``HTDemucs`` class of
``demucs/htdemucs.py`` in github.com/facebookresearch/demucs, with
``hdemucs.py`` (``HEncLayer``, ``HDecLayer``, ``ScaledEmbedding``, the
spectrogram's padding), ``transformer.py`` (the cross-domain Transformer
and its sinusoidal embeddings), ``demucs.py`` (``DConv``, ``LayerScale``)
and ``spec.py``. Module and parameter names are the published ones, so one
state dict loads here, in the program and in the published model.

This file imports only ``torch``. Departures from the published code:

- Only the published defaults' paths exist; the constructor raises on what
  they leave off: Wiener iterations, ``multi_freqs``, sparse attention,
  CAPE and scaled embeddings, ``bottom_channels``, ``cac=False``,
  ``t_cross_first``, Transformer layers other than the published ones
  (pre-LayerNorm with LayerScale, an output GroupNorm, no dropout), a
  random sine shift, ``rewrite=False``, and a depth at which the frequency
  axis would fall to the kernel's size (the branches' merged layers).
- Attention is written out: softmax(Q K^T / sqrt(head dim)) V, with Q, K
  and V from ``nn.MultiheadAttention``'s packed ``in_proj_weight`` and
  ``in_proj_bias`` and its ``out_proj``. No dropout (evaluation only).
- The iSTFT is written out (``torch.fft.irfft``, the window, overlap-add
  and division by the window's squared envelope, as ``torch.istft`` with
  ``normalized=True, center=True`` does), so that the model also runs on
  the meta device, where ``torch.istft`` does not.
- ``pad1d``'s check that the padded signal holds the input (a device sync)
  is dropped.
- Evaluation only: an input shorter than ``segment`` seconds is padded to
  it and the output cropped back, as published; a longer one is taken at
  its own length (the published model's evaluation path fails on it).
- A (B, N) input is taken as (B, 1, N), and its output given back as
  (B, N) (one source) or (B, sources, N).
- The initial weights are PyTorch's defaults with LayerScale's and the
  frequency embedding's scales; the published ``rescale`` and smooth
  embedding initialisation are not applied (weights are loaded).
- Everything runs in float32 with cuDNN's and cuBLAS's TF32 switches off
  (``tf32_switches(False)``, restored after the forward).
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


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


# ------------------------------------------------------------ embeddings

def create_sin_embedding(length: int, dim: int, shift: int = 0, device="cpu",
                         max_period: float = 10000) -> torch.Tensor:
    """(length, 1, dim): cos of each position's phases, then their sin."""
    assert dim % 2 == 0
    pos = shift + torch.arange(length, device=device).view(-1, 1, 1)
    half_dim = dim // 2
    adim = torch.arange(dim // 2, device=device).view(1, 1, -1)
    phase = pos / (max_period ** (adim / (half_dim - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def create_2d_sin_embedding(d_model: int, height: int, width: int, device="cpu",
                            max_period: float = 10000) -> torch.Tensor:
    """(1, d_model, height, width): the first half of the channels from the
    width (time) index, the second from the height (frequency) index, sin
    on even channels and cos on odd ones."""
    if d_model % 4 != 0:
        raise ValueError(f"Cannot use sin/cos positional encoding with odd dimension "
                         f"(got dim={d_model})")
    pe = torch.zeros(d_model, height, width)
    d_model = int(d_model / 2)
    div_term = torch.exp(torch.arange(0.0, d_model, 2) * -(math.log(max_period) / d_model))
    pos_w = torch.arange(0.0, width).unsqueeze(1)
    pos_h = torch.arange(0.0, height).unsqueeze(1)
    sin_w = torch.sin(pos_w * div_term).transpose(0, 1).unsqueeze(1)
    cos_w = torch.cos(pos_w * div_term).transpose(0, 1).unsqueeze(1)
    sin_h = torch.sin(pos_h * div_term).transpose(0, 1).unsqueeze(2)
    cos_h = torch.cos(pos_h * div_term).transpose(0, 1).unsqueeze(2)
    pe[0:d_model:2, :, :] = sin_w.repeat(1, height, 1)
    pe[1:d_model:2, :, :] = cos_w.repeat(1, height, 1)
    pe[d_model::2, :, :] = sin_h.repeat(1, 1, width)
    pe[d_model + 1::2, :, :] = cos_h.repeat(1, 1, width)
    return pe[None, :].to(device)


class ScaledEmbedding(nn.Module):
    """``nn.Embedding`` whose output is multiplied by ``scale``."""

    def __init__(self, num_embeddings: int, embedding_dim: int, scale: float = 10.0) -> None:
        super().__init__()
        # nn.Embedding's N(0, 1) start over ``scale``, drawn by a factory:
        # in place on the meta device it would take a slow decomposition
        self.embedding = nn.Embedding(num_embeddings, embedding_dim, _weight=torch.randn(
            num_embeddings, embedding_dim).mul_(1.0 / scale))
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding(x) * self.scale


# ------------------------------------------------------------ convolutions

class LayerScale(nn.Module):
    """A learnt scale per channel (on dim 1, or on the last dim)."""

    def __init__(self, channels: int, init: float = 0.0, channel_last: bool = False) -> None:
        super().__init__()
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.full((channels,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x if self.channel_last else self.scale[:, None] * x


class DConv(nn.Module):
    """Residual branches of dilated convolutions: ``layers[d]`` is
    Conv1d(C, C / compress, 3, dilation 2^d), GroupNorm(1), GELU,
    Conv1d(1x1) to 2 C, GroupNorm(1), GLU, LayerScale, added to its input."""

    def __init__(self, channels: int, compress: float = 4, depth: int = 2,
                 init: float = 1e-4, gelu: bool = True, kernel: int = 3) -> None:
        super().__init__()
        hidden = int(channels / compress)
        dilate = depth > 0
        act = nn.GELU if gelu else nn.ReLU
        self.layers = nn.ModuleList()
        for d in range(abs(depth)):
            dilation = 2 ** d if dilate else 1
            padding = dilation * (kernel // 2)
            self.layers.append(nn.Sequential(
                nn.Conv1d(channels, hidden, kernel, dilation=dilation, padding=padding),
                nn.GroupNorm(1, hidden), act(),
                nn.Conv1d(hidden, 2 * channels, 1),
                nn.GroupNorm(1, 2 * channels), nn.GLU(1),
                LayerScale(channels, init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer(x)
        return x


def _norm(norm: bool, groups: int):
    return (lambda d: nn.GroupNorm(groups, d)) if norm else (lambda d: nn.Identity())


class HEncLayer(nn.Module):
    """One encoder layer of either branch: the strided convolution (a
    (kernel, 1) Conv2d over frequency on the spectral branch), GELU, the
    ``DConv`` (along time, frequency folded into the batch), a 1x1 (or
    wider) convolution to twice the channels and a GLU."""

    def __init__(self, chin: int, chout: int, kernel_size: int = 8, stride: int = 4,
                 norm_groups: int = 1, freq: bool = True, dconv: bool = True,
                 norm: bool = True, context: int = 0, dconv_kw: Optional[dict] = None) -> None:
        super().__init__()
        norm_fn = _norm(norm, norm_groups)
        pad = kernel_size // 4
        self.freq, self.stride = freq, stride
        klass = nn.Conv1d
        if freq:
            kernel_size, stride, pad, klass = [kernel_size, 1], [stride, 1], [pad, 0], nn.Conv2d
        self.conv = klass(chin, chout, kernel_size, stride, pad)
        self.norm1 = norm_fn(chout)
        self.rewrite = klass(chout, 2 * chout, 1 + 2 * context, 1, context)
        self.norm2 = norm_fn(2 * chout)
        self.dconv = DConv(chout, **(dconv_kw or {})) if dconv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.freq:
            le = x.shape[-1]
            if le % self.stride:
                x = F.pad(x, (0, self.stride - le % self.stride))
        y = F.gelu(self.norm1(self.conv(x)))
        if self.dconv is not None:
            if self.freq:
                B, C, Fr, T = y.shape
                y = y.permute(0, 2, 1, 3).reshape(-1, C, T)
            y = self.dconv(y)
            if self.freq:
                y = y.view(B, Fr, C, T).permute(0, 2, 1, 3)
        return F.glu(self.norm2(self.rewrite(y)), dim=1)


class HDecLayer(nn.Module):
    """One decoder layer of either branch: the skip added, a convolution of
    kernel 1 + 2 context to twice the channels and a GLU, the ``DConv`` if
    any, the strided transposed convolution, its padding cropped, and GELU
    except on the outermost layer."""

    def __init__(self, chin: int, chout: int, last: bool = False, kernel_size: int = 8,
                 stride: int = 4, norm_groups: int = 1, freq: bool = True, dconv: bool = True,
                 norm: bool = True, context: int = 1, dconv_kw: Optional[dict] = None) -> None:
        super().__init__()
        norm_fn = _norm(norm, norm_groups)
        self.pad = kernel_size // 4
        self.last, self.freq, self.chin = last, freq, chin
        klass, klass_tr = nn.Conv1d, nn.ConvTranspose1d
        if freq:
            kernel_size, stride = [kernel_size, 1], [stride, 1]
            klass, klass_tr = nn.Conv2d, nn.ConvTranspose2d
        self.conv_tr = klass_tr(chin, chout, kernel_size, stride)
        self.norm2 = norm_fn(chout)
        self.rewrite = klass(chin, 2 * chin, 1 + 2 * context, 1, context)
        self.norm1 = norm_fn(2 * chin)
        self.dconv = DConv(chin, **(dconv_kw or {})) if dconv else None

    def forward(self, x: torch.Tensor, skip: torch.Tensor, length: int) -> torch.Tensor:
        y = F.glu(self.norm1(self.rewrite(x + skip)), dim=1)
        if self.dconv is not None:
            if self.freq:
                B, C, Fr, T = y.shape
                y = y.permute(0, 2, 1, 3).reshape(-1, C, T)
            y = self.dconv(y)
            if self.freq:
                y = y.view(B, Fr, C, T).permute(0, 2, 1, 3)
        z = self.norm2(self.conv_tr(y))
        if self.freq:
            z = z[..., self.pad:-self.pad, :]
        else:
            z = z[..., self.pad:self.pad + length]
        return z if self.last else F.gelu(z)


# ------------------------------------------------------------ Transformer

class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``batch_first``), with the
    attention written out."""

    def __init__(self, embed_dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        B, T, C = q.shape
        S = kv.shape[1]
        H = self.num_heads
        D = C // H
        w, b = self.in_proj_weight, self.in_proj_bias
        Q = F.linear(q, w[:C], b[:C]).view(B, T, H, D).transpose(1, 2)
        K = F.linear(kv, w[C:2 * C], b[C:2 * C]).view(B, S, H, D).transpose(1, 2)
        V = F.linear(kv, w[2 * C:], b[2 * C:]).view(B, S, H, D).transpose(1, 2)
        attn = torch.softmax(torch.matmul(Q, K.transpose(-2, -1)) / math.sqrt(D), dim=-1)
        out = torch.matmul(attn, V).transpose(1, 2).reshape(B, T, C)
        return F.linear(out, self.out_proj.weight, self.out_proj.bias)


class MyGroupNorm(nn.GroupNorm):
    """GroupNorm over (B, T, C): with one group, over each example's T x C."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class MyTransformerEncoderLayer(nn.Module):
    """Self-attention then the FFN, each pre-LayerNorm with LayerScale, then
    a GroupNorm of one group (``norm_first``, ``norm_out``, ``layer_scale``)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, activation,
                 init_values: float = 1e-4, layer_norm_eps: float = 1e-5) -> None:
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm_out = MyGroupNorm(1, d_model)
        self.gamma_1 = LayerScale(d_model, init_values, True)
        self.gamma_2 = LayerScale(d_model, init_values, True)
        self.activation = activation

    def _ff_block(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.activation(self.linear1(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.gamma_1(self.self_attn(h, h))
        x = x + self.gamma_2(self._ff_block(self.norm2(x)))
        return self.norm_out(x)


class CrossTransformerEncoderLayer(nn.Module):
    """Cross-attention (queries ``norm1(q)``, keys and values ``norm2(k)``)
    then the FFN on ``norm3``, each with LayerScale, then a GroupNorm of one
    group."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, activation,
                 init_values: float = 1e-4, layer_norm_eps: float = 1e-5) -> None:
        super().__init__()
        self.cross_attn = MultiheadAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm3 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm_out = MyGroupNorm(1, d_model)
        self.gamma_1 = LayerScale(d_model, init_values, True)
        self.gamma_2 = LayerScale(d_model, init_values, True)
        self.activation = activation

    def _ff_block(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.activation(self.linear1(x)))

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        x = q + self.gamma_1(self.cross_attn(self.norm1(q), self.norm2(k)))
        x = x + self.gamma_2(self._ff_block(self.norm3(x)))
        return self.norm_out(x)


class CrossTransformerEncoder(nn.Module):
    """The cross-domain Transformer: spectral tokens (t, f order) and
    temporal tokens, LayerNorm and sinusoidal embeddings in, then layers
    alternating self-attention within each branch (even layers) and
    cross-attention between them (odd layers)."""

    def __init__(self, dim: int, hidden_scale: float = 4.0, num_heads: int = 8,
                 num_layers: int = 6, max_period: float = 10000.0, gelu: bool = True,
                 weight_pos_embed: float = 1.0) -> None:
        super().__init__()
        assert dim % num_heads == 0
        hidden_dim = int(dim * hidden_scale)
        self.num_layers = num_layers
        self.max_period = max_period
        self.weight_pos_embed = weight_pos_embed
        activation = F.gelu if gelu else F.relu
        self.norm_in = nn.LayerNorm(dim)
        self.norm_in_t = nn.LayerNorm(dim)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        kw = dict(d_model=dim, nhead=num_heads, dim_feedforward=hidden_dim, activation=activation)
        for idx in range(num_layers):
            klass = MyTransformerEncoderLayer if idx % 2 == 0 else CrossTransformerEncoderLayer
            self.layers.append(klass(**kw))
            self.layers_t.append(klass(**kw))

    def forward(self, x: torch.Tensor, xt: torch.Tensor):
        B, C, Fr, T1 = x.shape
        pos_emb_2d = create_2d_sin_embedding(C, Fr, T1, x.device, self.max_period)
        pos_emb_2d = pos_emb_2d.permute(0, 3, 2, 1).reshape(1, T1 * Fr, C)
        x = x.permute(0, 3, 2, 1).reshape(B, T1 * Fr, C)
        x = self.norm_in(x)
        x = x + self.weight_pos_embed * pos_emb_2d
        B, C, T2 = xt.shape
        xt = xt.permute(0, 2, 1)
        pos_emb = create_sin_embedding(T2, C, device=xt.device, max_period=self.max_period)
        pos_emb = pos_emb.permute(1, 0, 2)
        xt = self.norm_in_t(xt)
        xt = xt + self.weight_pos_embed * pos_emb
        for idx in range(self.num_layers):
            if idx % 2 == 0:
                x = self.layers[idx](x)
                xt = self.layers_t[idx](xt)
            else:
                old_x = x
                x = self.layers[idx](x, xt)
                xt = self.layers_t[idx](xt, old_x)
        x = x.reshape(B, T1, Fr, C).permute(0, 3, 2, 1)
        xt = xt.permute(0, 2, 1)
        return x, xt


# ------------------------------------------------------------ spectrograms

def pad1d(x: torch.Tensor, paddings, mode: str = "constant", value: float = 0.0) -> torch.Tensor:
    """``F.pad`` that also reflects a signal shorter than its padding (by
    zero-padding it first)."""
    length = x.shape[-1]
    padding_left, padding_right = paddings
    if mode == "reflect":
        max_pad = max(padding_left, padding_right)
        if length <= max_pad:
            extra_pad = max_pad - length + 1
            extra_pad_right = min(padding_right, extra_pad)
            extra_pad_left = extra_pad - extra_pad_right
            paddings = (padding_left - extra_pad_left, padding_right - extra_pad_right)
            x = F.pad(x, (extra_pad_left, extra_pad_right))
    return F.pad(x, paddings, mode, value)


def spectro(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    *other, length = x.shape
    x = x.reshape(-1, length)
    z = torch.stft(x, n_fft, hop_length, window=torch.hann_window(n_fft).to(x), win_length=n_fft,
                   normalized=True, center=True, return_complex=True, pad_mode="reflect")
    _, freqs, frame = z.shape
    return z.view(*other, freqs, frame)


def ispectro(z: torch.Tensor, hop_length: int, length: int) -> torch.Tensor:
    """``torch.istft(z, n_fft, hop_length, hann window, normalized=True,
    length=length, center=True)``, written out."""
    *other, freqs, frames = z.shape
    n_fft = 2 * freqs - 2
    z = z.reshape(-1, freqs, frames)
    window = torch.hann_window(n_fft).to(z.real)
    y = torch.fft.irfft(z, n=n_fft, dim=-2, norm="ortho") * window[:, None]
    parts = n_fft // hop_length
    assert parts * hop_length == n_fft
    # overlap-add: frame j's k-th hop lands in output block j + k
    seg = y.reshape(-1, parts, hop_length, frames).permute(0, 1, 3, 2)
    out = y.new_zeros(seg.shape[0], frames + parts - 1, hop_length)
    env = y.new_zeros(frames + parts - 1, hop_length)
    wsq = (window ** 2).reshape(parts, hop_length)
    for k in range(parts):
        out[:, k:k + frames] += seg[:, k]
        env[k:k + frames] += wsq[k]
    start = n_fft // 2
    out = out.reshape(out.shape[0], -1)[:, start:start + length]
    env = env.reshape(-1)[start:start + length]
    return (out / env).view(*other, length)


# ------------------------------------------------------------ the model

UNSUPPORTED = {
    "wiener_iters": 0, "end_iters": 0, "multi_freqs": None, "bottom_channels": 0,
    "cac": True, "rewrite": True, "t_cross_first": False, "t_sparse_self_attn": False,
    "t_sparse_cross_attn": False, "t_emb": "sin", "t_norm_in": True, "t_norm_in_group": False,
    "t_group_norm": False, "t_norm_first": True, "t_norm_out": True, "t_layer_scale": True,
    "t_dropout": 0.0, "t_sin_random_shift": 0,
}


class HTDemucs(nn.Module):
    """The published defaults, with ``sources`` (names) and
    ``audio_channels``; every published keyword is taken, and those whose
    paths are left out must keep their default (``UNSUPPORTED``)."""

    def __init__(self, sources: Sequence[str], audio_channels: int = 2, channels: int = 48,
                 channels_time: Optional[int] = None, growth: float = 2, nfft: int = 4096,
                 depth: int = 4, freq_emb: float = 0.2, emb_scale: float = 10,
                 emb_smooth: bool = True, kernel_size: int = 8, time_stride: int = 2,
                 stride: int = 4, context: int = 1, context_enc: int = 0,
                 norm_starts: int = 4, norm_groups: int = 4, dconv_mode: int = 1,
                 dconv_depth: int = 2, dconv_comp: int = 8, dconv_init: float = 1e-3,
                 t_layers: int = 5, t_hidden_scale: float = 4.0, t_heads: int = 8,
                 t_max_positions: int = 10000, t_max_period: float = 10000.0,
                 t_weight_decay: float = 0.0, t_lr=None, t_gelu: bool = True,
                 t_weight_pos_embed: float = 1.0, rescale: float = 0.1,
                 samplerate: int = 44100, segment: float = 10, use_train_segment: bool = True,
                 **left_off) -> None:
        super().__init__()
        for key, value in left_off.items():
            if key not in UNSUPPORTED and not key.startswith(("t_cape_", "t_mask_",
                                                              "t_sparse", "t_global",
                                                              "t_auto_", "multi_freqs",
                                                              "wiener_residual")):
                raise TypeError(f"HTDemucs got an unexpected keyword {key!r}")
            if key in UNSUPPORTED and value != UNSUPPORTED[key]:
                raise ValueError(f"HTDemucs: {key}={value!r} is not implemented "
                                 f"(only {UNSUPPORTED[key]!r})")
        if t_layers < 1:
            raise ValueError("HTDemucs: t_layers must be at least 1")
        self.sources = list(sources)
        self.audio_channels = audio_channels
        self.depth = depth
        self.nfft = nfft
        self.hop_length = nfft // 4
        self.samplerate = samplerate
        self.segment = segment
        self.use_train_segment = use_train_segment
        self.freq_emb = None
        self.encoder, self.decoder = nn.ModuleList(), nn.ModuleList()
        self.tencoder, self.tdecoder = nn.ModuleList(), nn.ModuleList()
        chin, chin_z = audio_channels, 2 * audio_channels
        chout, chout_z = channels_time or channels, channels
        freqs = nfft // 2
        dconv_kw = {"depth": dconv_depth, "compress": dconv_comp, "init": dconv_init,
                    "gelu": True}
        for index in range(depth):
            if freqs <= kernel_size:
                raise ValueError("HTDemucs: the branches' merged layers (frequencies down to "
                                 "the kernel) are not implemented")
            kw = {"kernel_size": kernel_size, "stride": stride, "norm": index >= norm_starts,
                  "norm_groups": norm_groups, "dconv_kw": dconv_kw}
            self.encoder.append(HEncLayer(chin_z, chout_z, freq=True, dconv=bool(dconv_mode & 1),
                                          context=context_enc, **kw))
            self.tencoder.append(HEncLayer(chin, chout, freq=False, dconv=bool(dconv_mode & 1),
                                           context=context_enc, **kw))
            if index == 0:
                chin = audio_channels * len(self.sources)
                chin_z = 2 * chin
            self.decoder.insert(0, HDecLayer(chout_z, chin_z, last=index == 0, freq=True,
                                             dconv=bool(dconv_mode & 2), context=context, **kw))
            self.tdecoder.insert(0, HDecLayer(chout, chin, last=index == 0, freq=False,
                                              dconv=bool(dconv_mode & 2), context=context, **kw))
            chin, chin_z = chout, chout_z
            chout, chout_z = int(growth * chout), int(growth * chout_z)
            freqs //= stride
            if index == 0 and freq_emb:
                self.freq_emb = ScaledEmbedding(freqs, chin_z, scale=emb_scale)
                self.freq_emb_scale = freq_emb
        self.crosstransformer = CrossTransformerEncoder(
            dim=channels * growth ** (depth - 1), hidden_scale=t_hidden_scale,
            num_heads=t_heads, num_layers=t_layers, max_period=t_max_period, gelu=t_gelu,
            weight_pos_embed=t_weight_pos_embed)

    def _spec(self, x: torch.Tensor) -> torch.Tensor:
        hl = self.hop_length
        le = int(math.ceil(x.shape[-1] / hl))
        pad = hl // 2 * 3
        x = pad1d(x, (pad, pad + le * hl - x.shape[-1]), mode="reflect")
        z = spectro(x, self.nfft, hl)[..., :-1, :]
        return z[..., 2:2 + le]

    def _ispec(self, z: torch.Tensor, length: int) -> torch.Tensor:
        hl = self.hop_length
        z = F.pad(z, (0, 0, 0, 1))
        z = F.pad(z, (2, 2))
        pad = hl // 2 * 3
        le = hl * int(math.ceil(length / hl)) + 2 * pad
        x = ispectro(z, hl, le)
        return x[..., pad:pad + length]

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """(B, audio_channels, N) -> (B, sources, audio_channels, N); a
        (B, N) input -> (B, N) for one source, (B, sources, N) otherwise."""
        with tf32_switches(False):
            flat = mix.dim() == 2
            out = self._forward(mix[:, None] if flat else mix)
            if flat:
                out = out[:, :, 0]
                if out.shape[1] == 1:
                    out = out[:, 0]
            return out

    def _forward(self, mix: torch.Tensor) -> torch.Tensor:
        length = mix.shape[-1]
        length_pre_pad = None
        if self.use_train_segment:
            training_length = int(self.segment * self.samplerate)
            if length < training_length:
                length_pre_pad = length
                mix = F.pad(mix, (0, training_length - length))
                length = training_length
        z = self._spec(mix)
        B, C, Fr, T = z.shape
        x = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(B, C * 2, Fr, T)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (1e-5 + std)
        xt = mix
        meant = xt.mean(dim=(1, 2), keepdim=True)
        stdt = xt.std(dim=(1, 2), keepdim=True)
        xt = (xt - meant) / (1e-5 + stdt)

        saved: List[torch.Tensor] = []
        saved_t: List[torch.Tensor] = []
        lengths: List[int] = []
        lengths_t: List[int] = []
        for idx, encode in enumerate(self.encoder):
            lengths.append(x.shape[-1])
            lengths_t.append(xt.shape[-1])
            xt = self.tencoder[idx](xt)
            saved_t.append(xt)
            x = encode(x)
            if idx == 0 and self.freq_emb is not None:
                frs = torch.arange(x.shape[-2], device=x.device)
                emb = self.freq_emb(frs).t()[None, :, :, None].expand_as(x)
                x = x + self.freq_emb_scale * emb
            saved.append(x)

        x, xt = self.crosstransformer(x, xt)

        for idx, decode in enumerate(self.decoder):
            x = decode(x, saved.pop(-1), lengths.pop(-1))
            xt = self.tdecoder[idx](xt, saved_t.pop(-1), lengths_t.pop(-1))

        S = len(self.sources)
        x = x.view(B, S, -1, Fr, T)
        x = x * std[:, None] + mean[:, None]
        Bm, Sm, Cm, Frm, Tm = x.shape
        zout = torch.view_as_complex(
            x.view(Bm, Sm, -1, 2, Frm, Tm).permute(0, 1, 2, 4, 5, 3).contiguous())
        x = self._ispec(zout, length)
        xt = xt.view(B, S, -1, length)
        xt = xt * stdt[:, None] + meant[:, None]
        x = xt + x
        if length_pre_pad:
            x = x[..., :length_pre_pad]
        return x

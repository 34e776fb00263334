"""Hybrid Transformer Demucs (HTDemucs) as a waveform denoiser.

Rouard, Massa, Défossez, "Hybrid Transformers for Music Source
Separation", ICASSP 2023 (arXiv:2211.08553): the ``HTDemucs`` class of
``demucs/htdemucs.py`` in github.com/facebookresearch/demucs (with
``hdemucs.py``, ``transformer.py``, ``demucs.py``'s ``DConv`` and
``spec.py``), at its published defaults. Two U-Nets side by side, a
temporal one on the waveform and a spectral one on the STFT (complex values
as channels), joined between their innermost layers by a cross-domain
Transformer whose layers alternate self-attention within each branch and
cross-attention between them. The output is the spectral branch's iSTFT
plus the temporal branch's waveform.

Module and parameter names are the published ones
(``crosstransformer.layers.1.cross_attn.in_proj_weight`` and so on), so a
published state dict loads. Attention runs through
``F.scaled_dot_product_attention`` on the packed in-projection. The forward
holds cuDNN's and cuBLAS's TF32 switches off (strict float32), restored on
exit. Under a profile it records the spans ``htdemucs.spec``,
``htdemucs.encoder``, ``htdemucs.transformer``, ``htdemucs.decoder`` and
``htdemucs.ispec``, and counts the tokens entering the Transformer
(``htdemucs.tokens``: spectral plus temporal, every example).

What the published defaults leave off is not implemented and raises when
asked for (``UNSUPPORTED``): Wiener iterations, ``multi_freqs``, sparse
attention, CAPE and scaled embeddings, ``bottom_channels``, ``cac=False``,
``t_cross_first``, Transformer layers other than the published ones
(pre-LayerNorm with LayerScale, an output GroupNorm, no dropout), a random
sine shift, ``rewrite=False`` and the branches' merged layers (a depth at
which the frequency axis would fall to the kernel's size). In evaluation, an input
shorter than ``segment`` seconds is padded to it and the output cropped
back, as published; a longer one is taken at its own length. The JAX
package has no such model: ``portbench/ref/models/htdemucs.py`` is the
reference.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from musicfpaugment_torch.device import cudnn_tf32, matmul_tf32
from musicfpaugment_torch.utils.profiling import annotate, count

# published keywords whose paths are not implemented: the one value taken
# (the Transformer only as published: pre-LayerNorm with LayerScale and an
# output GroupNorm, no dropout, sine embeddings)
UNSUPPORTED = {
    "wiener_iters": 0, "end_iters": 0, "multi_freqs": None, "bottom_channels": 0,
    "cac": True, "rewrite": True, "t_cross_first": False, "t_sparse_self_attn": False,
    "t_sparse_cross_attn": False, "t_emb": "sin", "t_norm_in": True, "t_norm_in_group": False,
    "t_group_norm": False, "t_norm_first": True, "t_norm_out": True, "t_layer_scale": True,
    "t_dropout": 0.0, "t_sin_random_shift": 0,
}
# published keywords that only the paths left out read
IGNORED_PREFIXES = ("t_cape_", "t_mask_", "t_sparse", "t_global", "t_auto_", "multi_freqs",
                    "wiener_residual")


# ------------------------------------------------------------ embeddings

def sin_embedding(length: int, dim: int, max_period: float = 10000) -> torch.Tensor:
    """(length, dim) float32 on the CPU: position ``t``'s cos(t / P^(i / (dim/2 - 1)))
    for i < dim / 2, then the sin of the same phases (``create_sin_embedding``)."""
    pos = torch.arange(length).view(-1, 1)
    half = dim // 2
    adim = torch.arange(half).view(1, -1)
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def sin_embedding_2d(d_model: int, height: int, width: int,
                     max_period: float = 10000) -> torch.Tensor:
    """(d_model, height, width) float32 on the CPU: the first half of the
    channels from the width (time) index, the second half from the height
    (frequency) index, sin on even channels and cos on odd ones, at
    frequencies exp(-2k ln(P) / (d_model / 2)) (``create_2d_sin_embedding``)."""
    if d_model % 4:
        raise ValueError(f"the 2-D sine embedding needs a width divisible by 4, not {d_model}")
    pe = torch.zeros(d_model, height, width)
    half = d_model // 2
    div_term = torch.exp(torch.arange(0.0, half, 2) * -(math.log(max_period) / half))
    w = torch.arange(0.0, width).unsqueeze(1) * div_term  # (width, half / 2)
    h = torch.arange(0.0, height).unsqueeze(1) * div_term  # (height, half / 2)
    pe[0:half:2] = torch.sin(w).t()[:, None, :].expand(-1, height, -1)
    pe[1:half:2] = torch.cos(w).t()[:, None, :].expand(-1, height, -1)
    pe[half::2] = torch.sin(h).t()[:, :, None].expand(-1, -1, width)
    pe[half + 1::2] = torch.cos(h).t()[:, :, None].expand(-1, -1, width)
    return pe


class ScaledEmbedding(nn.Module):
    """``nn.Embedding`` whose output is multiplied by ``scale``; ``smooth``
    starts it as a normalised running sum of Gaussians."""

    def __init__(self, num_embeddings: int, embedding_dim: int, scale: float = 10.0,
                 smooth: bool = False) -> None:
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        if smooth:
            weight = torch.cumsum(self.embedding.weight.data, dim=0)
            weight = weight / torch.arange(1, num_embeddings + 1).to(weight).sqrt()[:, None]
            self.embedding.weight.data[:] = weight
        self.embedding.weight.data /= scale
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
    """Residual branches of dilated convolutions along time: ``layers[d]``
    is Conv1d(C, C / compress, 3, dilation 2^d), GroupNorm(1), GELU,
    Conv1d(1x1) to 2 C, GroupNorm(1), GLU and LayerScale, added to its
    input."""

    def __init__(self, channels: int, compress: float = 4, depth: int = 2,
                 init: float = 1e-4, gelu: bool = True, kernel: int = 3) -> None:
        super().__init__()
        hidden = int(channels / compress)
        act = nn.GELU if gelu else nn.ReLU
        self.layers = nn.ModuleList()
        for d in range(abs(depth)):
            dilation = 2 ** d if depth > 0 else 1
            self.layers.append(nn.Sequential(
                nn.Conv1d(channels, hidden, kernel, dilation=dilation,
                          padding=dilation * (kernel // 2)),
                nn.GroupNorm(1, hidden), act(),
                nn.Conv1d(hidden, 2 * channels, 1),
                nn.GroupNorm(1, 2 * channels), nn.GLU(1),
                LayerScale(channels, init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer(x)
        return x


def _along_time(dconv: DConv, y: torch.Tensor) -> torch.Tensor:
    """``dconv`` along the last axis; a spectral (B, C, F, T) input has its
    frequencies folded into the batch."""
    if y.dim() == 3:
        return dconv(y)
    B, C, Fr, T = y.shape
    y = dconv(y.permute(0, 2, 1, 3).reshape(B * Fr, C, T))
    return y.view(B, Fr, C, T).permute(0, 2, 1, 3)


def _norm(norm: bool, groups: int):
    return (lambda d: nn.GroupNorm(groups, d)) if norm else (lambda d: nn.Identity())


class HEncLayer(nn.Module):
    """One encoder layer of either branch: the strided convolution (a
    (kernel, 1) Conv2d over frequency on the spectral branch; the waveform
    first padded to a multiple of the stride), GELU, the ``DConv``, a
    convolution of kernel 1 + 2 context to twice the channels and a GLU."""

    def __init__(self, chin: int, chout: int, kernel_size: int = 8, stride: int = 4,
                 norm_groups: int = 1, freq: bool = True, dconv: bool = True,
                 norm: bool = True, context: int = 0, dconv_kw: Optional[dict] = None) -> None:
        super().__init__()
        norm_fn = _norm(norm, norm_groups)
        pad = kernel_size // 4
        self.freq, self.stride = freq, stride
        klass = nn.Conv1d
        if freq:
            kernel_size, stride, pad, klass = (kernel_size, 1), (stride, 1), (pad, 0), nn.Conv2d
        self.conv = klass(chin, chout, kernel_size, stride, pad)
        self.norm1 = norm_fn(chout)
        self.rewrite = klass(chout, 2 * chout, 1 + 2 * context, 1, context)
        self.norm2 = norm_fn(2 * chout)
        self.dconv = DConv(chout, **(dconv_kw or {})) if dconv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.freq and x.shape[-1] % self.stride:
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        y = F.gelu(self.norm1(self.conv(x)))
        if self.dconv is not None:
            y = _along_time(self.dconv, y)
        return F.glu(self.norm2(self.rewrite(y)), dim=1)


class HDecLayer(nn.Module):
    """One decoder layer of either branch: the skip added, a convolution of
    kernel 1 + 2 context (3 x 3 on the spectral branch) to twice the
    channels and a GLU, the ``DConv`` if any, the strided transposed
    convolution with its padding cropped, and GELU but on the outermost
    layer."""

    def __init__(self, chin: int, chout: int, last: bool = False, kernel_size: int = 8,
                 stride: int = 4, norm_groups: int = 1, freq: bool = True, dconv: bool = True,
                 norm: bool = True, context: int = 1, dconv_kw: Optional[dict] = None) -> None:
        super().__init__()
        norm_fn = _norm(norm, norm_groups)
        self.pad = kernel_size // 4
        self.last, self.freq = last, freq
        klass, klass_tr = nn.Conv1d, nn.ConvTranspose1d
        if freq:
            kernel_size, stride = (kernel_size, 1), (stride, 1)
            klass, klass_tr = nn.Conv2d, nn.ConvTranspose2d
        self.conv_tr = klass_tr(chin, chout, kernel_size, stride)
        self.norm2 = norm_fn(chout)
        self.rewrite = klass(chin, 2 * chin, 1 + 2 * context, 1, context)
        self.norm1 = norm_fn(2 * chin)
        self.dconv = DConv(chin, **(dconv_kw or {})) if dconv else None

    def forward(self, x: torch.Tensor, skip: torch.Tensor, length: int) -> torch.Tensor:
        y = F.glu(self.norm1(self.rewrite(x + skip)), dim=1)
        if self.dconv is not None:
            y = _along_time(self.dconv, y)
        z = self.norm2(self.conv_tr(y))
        z = z[..., self.pad:-self.pad, :] if self.freq else z[..., self.pad:self.pad + length]
        return z if self.last else F.gelu(z)


# ------------------------------------------------------------ Transformer

class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (``batch_first``, one packed
    in-projection) over ``F.scaled_dot_product_attention``."""

    def __init__(self, embed_dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, q: torch.Tensor, kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, C) queries over (B, S, C) keys and values (``kv``; the
        queries themselves when None) -> (B, T, C)."""
        B, T, C = q.shape
        H = self.num_heads
        if kv is None:
            Q, K, V = F.linear(q, self.in_proj_weight, self.in_proj_bias) \
                .view(B, T, 3, H, C // H).permute(2, 0, 3, 1, 4)
        else:
            w, b = self.in_proj_weight, self.in_proj_bias
            Q = F.linear(q, w[:C], b[:C]).view(B, T, H, C // H).transpose(1, 2)
            K, V = F.linear(kv, w[C:], b[C:]).view(B, kv.shape[1], 2, H, C // H) \
                .permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(Q, K, V)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, C))


class MyGroupNorm(nn.GroupNorm):
    """GroupNorm over (B, T, C): with one group, over each example's T x C."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class _Layer(nn.Module):
    """What the self- and cross-attention layers share: the FFN, the
    LayerScales and the output GroupNorm of one group over the example."""

    def __init__(self, d_model: int, dim_feedforward: int, activation,
                 init_values: float = 1e-4) -> None:
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm_out = MyGroupNorm(1, d_model)
        self.gamma_1 = LayerScale(d_model, init_values, True)
        self.gamma_2 = LayerScale(d_model, init_values, True)
        self.activation = activation

    def _ff_block(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.activation(self.linear1(x)))


class MyTransformerEncoderLayer(_Layer):
    """Self-attention then the FFN, each pre-LayerNorm (``norm1``,
    ``norm2``) with LayerScale, then the output GroupNorm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, activation,
                 layer_norm_eps: float = 1e-5) -> None:
        super().__init__(d_model, dim_feedforward, activation)
        self.self_attn = MultiheadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.gamma_1(self.self_attn(self.norm1(x)))
        return self.norm_out(x + self.gamma_2(self._ff_block(self.norm2(x))))


class CrossTransformerEncoderLayer(_Layer):
    """Cross-attention (queries ``norm1(q)``, keys and values ``norm2(k)``),
    then the FFN on ``norm3``, each with LayerScale, then the output
    GroupNorm."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, activation,
                 layer_norm_eps: float = 1e-5) -> None:
        super().__init__(d_model, dim_feedforward, activation)
        self.cross_attn = MultiheadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm2 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.norm3 = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        x = q + self.gamma_1(self.cross_attn(self.norm1(q), self.norm2(k)))
        return self.norm_out(x + self.gamma_2(self._ff_block(self.norm3(x))))


class CrossTransformerEncoder(nn.Module):
    """The cross-domain Transformer: the spectral (B, C, F, T1) map as
    T1 x F tokens in (t, f) order and the temporal (B, C, T2) map as T2
    tokens, each through its LayerNorm plus a sinusoidal embedding (2-D,
    1-D), then layers alternating self-attention within each branch (even
    layers) and cross-attention between them (odd layers: each branch
    attends to the other as it stood before the layer)."""

    def __init__(self, dim: int, hidden_scale: float = 4.0, num_heads: int = 8,
                 num_layers: int = 6, max_period: float = 10000.0, gelu: bool = True,
                 weight_pos_embed: float = 1.0) -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"the Transformer's width {dim} is not a multiple of "
                             f"{num_heads} heads")
        self.num_layers = num_layers
        self.max_period = max_period
        self.weight_pos_embed = weight_pos_embed
        self.norm_in = nn.LayerNorm(dim)
        self.norm_in_t = nn.LayerNorm(dim)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        kw = dict(d_model=dim, nhead=num_heads, dim_feedforward=int(dim * hidden_scale),
                  activation=F.gelu if gelu else F.relu)
        for idx in range(num_layers):
            klass = MyTransformerEncoderLayer if idx % 2 == 0 else CrossTransformerEncoderLayer
            self.layers.append(klass(**kw))
            self.layers_t.append(klass(**kw))
        # the embeddings by shape, on the device: made on the CPU as
        # published, their copy to the card would wait for the stream
        self._emb: Dict[Tuple, torch.Tensor] = {}

    def _embedding(self, key: Tuple, make, device: torch.device, dtype: torch.dtype):
        key = key + (str(device), dtype)
        emb = self._emb.get(key)
        if emb is None:
            emb = self._emb[key] = make().to(device=device, dtype=dtype)
        return emb

    def forward(self, x: torch.Tensor, xt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, C, Fr, T1 = x.shape
        T2 = xt.shape[-1]
        emb2 = self._embedding(("2d", C, Fr, T1), lambda: sin_embedding_2d(
            C, Fr, T1, self.max_period).permute(2, 1, 0).reshape(T1 * Fr, C), x.device, x.dtype)
        emb1 = self._embedding(("1d", C, T2), lambda: sin_embedding(T2, C, self.max_period),
                               xt.device, xt.dtype)
        x = self.norm_in(x.permute(0, 3, 2, 1).reshape(B, T1 * Fr, C))
        x = x + self.weight_pos_embed * emb2
        xt = self.norm_in_t(xt.transpose(1, 2)) + self.weight_pos_embed * emb1
        for idx in range(self.num_layers):
            if idx % 2 == 0:
                x, xt = self.layers[idx](x), self.layers_t[idx](xt)
            else:
                x, xt = self.layers[idx](x, xt), self.layers_t[idx](xt, x)
        return x.reshape(B, T1, Fr, C).permute(0, 3, 2, 1), xt.transpose(1, 2)


# ------------------------------------------------------------ the model

def _rescale_module(module: nn.Module, reference: float) -> None:
    """The published initial rescale: each convolution's weight and bias
    divided by sqrt(std(weight) / reference)."""
    for sub in module.modules():
        if isinstance(sub, (nn.Conv1d, nn.ConvTranspose1d, nn.Conv2d, nn.ConvTranspose2d)):
            scale = (sub.weight.std().detach() / reference) ** 0.5
            sub.weight.data /= scale
            if sub.bias is not None:
                sub.bias.data /= scale


class HTDemucs(nn.Module):
    """The published defaults; ``sources`` are the output's names. Every
    published keyword is taken; those whose paths are not implemented must
    keep their one value (``UNSUPPORTED``)."""

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
            if key in UNSUPPORTED:
                if value != UNSUPPORTED[key]:
                    raise ValueError(f"HTDemucs: {key}={value!r} is not implemented "
                                     f"(only {UNSUPPORTED[key]!r})")
            elif not key.startswith(IGNORED_PREFIXES):
                raise TypeError(f"HTDemucs got an unexpected keyword {key!r}")
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
                self.freq_emb = ScaledEmbedding(freqs, chin_z, scale=emb_scale, smooth=emb_smooth)
                self.freq_emb_scale = freq_emb
        if rescale:
            _rescale_module(self, rescale)
        self.crosstransformer = CrossTransformerEncoder(
            dim=int(channels * growth ** (depth - 1)), hidden_scale=t_hidden_scale,
            num_heads=t_heads, num_layers=t_layers, max_period=t_max_period, gelu=t_gelu,
            weight_pos_embed=t_weight_pos_embed)
        # the Hann window by device, made once: as the embeddings, its copy
        # to the card would wait for the stream
        self._windows: Dict[Tuple, torch.Tensor] = {}

    def _window(self, like: torch.Tensor) -> torch.Tensor:
        key = (str(like.device), like.dtype)
        win = self._windows.get(key)
        if win is None:
            win = self._windows[key] = torch.hann_window(self.nfft).to(like)
        return win

    def _spec(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, N) -> (B, C, nfft / 2, ceil(N / hop)) complex: reflect-padded
        by 3 / 2 hop on the left and to a whole number of hops on the right,
        the normalised STFT (periodic Hann, centred) without its last bin and
        its two first and two last frames."""
        hl = self.hop_length
        B, C, N = x.shape
        le = -(-N // hl)
        pad = hl // 2 * 3
        left, right = pad, pad + le * hl - N
        if N <= max(left, right):  # too short to reflect: zeros first
            extra = max(left, right) - N + 1
            extra_right = min(right, extra)
            x = F.pad(x, (extra - extra_right, extra_right))
            left, right = left - (extra - extra_right), right - extra_right
        x = F.pad(x, (left, right), mode="reflect").reshape(B * C, -1)
        z = torch.stft(x, self.nfft, hl, window=self._window(x), win_length=self.nfft,
                       normalized=True, center=True, return_complex=True, pad_mode="reflect")
        return z[:, :-1, 2:2 + le].reshape(B, C, self.nfft // 2, le)

    def _ispec(self, z: torch.Tensor, length: int) -> torch.Tensor:
        """The inverse of :meth:`_spec`: the last bin and two frames a side
        put back as zeros, the normalised iSTFT, cropped to ``length``."""
        hl = self.hop_length
        *other, Fr, T = z.shape
        z = F.pad(z.reshape(-1, Fr, T), (2, 2, 0, 1))
        pad = hl // 2 * 3
        le = hl * -(-length // hl) + 2 * pad
        x = torch.istft(z, self.nfft, hl, window=self._window(z.real), win_length=self.nfft,
                        normalized=True, length=le, center=True)
        return x[:, pad:pad + length].reshape(*other, length)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """(B, audio_channels, N) -> (B, sources, audio_channels, N); a
        (B, N) input -> (B, N) for one source, (B, sources, N) otherwise.
        In strict float32: cuDNN's and cuBLAS's TF32 switches off."""
        with cudnn_tf32(False), matmul_tf32(False):
            flat = mix.dim() == 2
            out = self._forward(mix[:, None] if flat else mix)
        if flat:
            out = out[:, :, 0]
            if out.shape[1] == 1:
                out = out[:, 0]
        return out

    def _forward(self, mix: torch.Tensor) -> torch.Tensor:
        length = mix.shape[-1]
        cropped = None
        if self.use_train_segment and not self.training:
            segment = int(self.segment * self.samplerate)
            if length < segment:
                cropped, length = length, segment
                mix = F.pad(mix, (0, segment - cropped))
        with annotate("htdemucs.spec"):
            z = self._spec(mix)
            B, C, Fr, T = z.shape
            x = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(B, 2 * C, Fr, T)
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            std = x.std(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) / (1e-5 + std)
            meant = mix.mean(dim=(1, 2), keepdim=True)
            stdt = mix.std(dim=(1, 2), keepdim=True)
            xt = (mix - meant) / (1e-5 + stdt)

        saved: List[torch.Tensor] = []
        saved_t: List[torch.Tensor] = []
        lengths_t: List[int] = []
        with annotate("htdemucs.encoder"):
            for idx, encode in enumerate(self.encoder):
                lengths_t.append(xt.shape[-1])
                xt = self.tencoder[idx](xt)
                saved_t.append(xt)
                x = encode(x)
                if idx == 0 and self.freq_emb is not None:
                    emb = self.freq_emb(torch.arange(x.shape[-2], device=x.device))
                    x = x + self.freq_emb_scale * emb.t()[None, :, :, None]
                saved.append(x)

        with annotate("htdemucs.transformer"):
            count("htdemucs.tokens", B * (x.shape[2] * x.shape[3] + xt.shape[2]))
            x, xt = self.crosstransformer(x, xt)

        with annotate("htdemucs.decoder"):
            for idx, decode in enumerate(self.decoder):
                x = decode(x, saved.pop(), 0)
                xt = self.tdecoder[idx](xt, saved_t.pop(), lengths_t.pop())

        with annotate("htdemucs.ispec"):
            S = len(self.sources)
            x = x.view(B, S, -1, Fr, T) * std[:, None] + mean[:, None]
            x = x.view(B, S, -1, 2, Fr, T).permute(0, 1, 2, 4, 5, 3).contiguous()
            x = self._ispec(torch.view_as_complex(x), length)
            out = xt.view(B, S, -1, length) * stdt[:, None] + meant[:, None] + x
        return out if cropped is None else out[..., :cropped]

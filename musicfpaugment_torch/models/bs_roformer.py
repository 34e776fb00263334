"""Band-Split RoPE Transformer (BS-RoFormer) as a waveform denoiser.

Lu, Wang, Kong, Hung, "Music Source Separation with Band-Split RoPE
Transformer", ICASSP 2024 (arXiv:2309.02612); the ``BSRoformer`` class of
``bs_roformer/bs_roformer.py`` in github.com/lucidrains/BS-RoFormer, with
``rotary_embedding_torch``'s rotary embedding. The complex STFT of the
waveform is cut into bands of unequal width along frequency; each band's
(real, imaginary) pairs go through their own RMSNorm and linear layer to one
token of width ``dim``. Axial blocks follow, each a Transformer along time
(every band on its own) and one across the bands (every frame on its own):
pre-RMSNorm attention with rotary position embeddings on the queries and
keys (frame indices in the time layers, band indices in the band layers),
then a pre-RMSNorm GELU feed-forward of four times the width, both with
residuals. After a last RMSNorm, a per-band MLP (Tanh, then a GLU) gives
each band's complex mask, which multiplies the mixture's STFT before the
iSTFT.

Module and parameter names are the published ones
(``layers.3.1.layers.0.0.to_qkv.weight``, ``band_split.to_features.5.1.bias``,
``mask_estimators.0.to_freqs.61.0.2.weight`` and so on); the dropouts' places
hold ``nn.Identity``. Attention runs through
``F.scaled_dot_product_attention``, with the heads as their own axis. The
forward holds cuBLAS's TF32 switch off (strict float32), restored on exit.
Under a profile it records the spans ``bsroformer.stft``,
``bsroformer.band_split``, ``bsroformer.transformer`` (every block),
``bsroformer.mask`` (the last RMSNorm, the mask MLPs and the complex
product) and ``bsroformer.istft``, and counts the tokens entering the
Transformer (``bsroformer.tokens``: examples x frames x bands).

The rotary embedding of q and k is one route, ``RotaryEmbedding.rotate_qk``:
on a CUDA tensor it launches the kernel of ``csrc/rope_qk.cu`` once an
attention layer (q and k rotated in one pass from the QKV projection's
output), or raises; on a CPU tensor it takes ``RotaryEmbedding.rotate``, the
plain version, on each. ``LAUNCHES`` counts the kernel's launches,
incremented where it is launched and nowhere else; under a profile the
launch also counts ``bsroformer.rope_launches`` and ``bsroformer.rope_bytes``
(the bytes it reads and writes).

Departures from the public code, each raising where it is asked for
(``UNSUPPORTED``): one audio channel (``stereo=True`` folds two channels
into the bands), one stem, no linear-attention layers
(``linear_transformer_depth``, 0 by default there), no dropout (evaluation
only), the STFT not normalised. The per-head output gates of the public
code's later versions (``to_gates``, which the paper does not describe) are
left out. The RoPE frequencies are computed, not kept as state. The iSTFT is
cropped to the input's length. A (B, N) input gives a (B, N) output, a
(B, 1, N) one (B, 1, N). The JAX package has no such model:
``portbench/ref/models/bs_roformer.py`` is the reference.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from musicfpaugment_torch.device import matmul_tf32
from musicfpaugment_torch.utils.profiling import annotate, count

# the published band layout: 62 bands over the 1,025 bins of a 2,048-point STFT
DEFAULT_FREQS_PER_BANDS = ((2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8
                           + (128, 129))
# published keywords whose paths are not implemented: the one value taken
UNSUPPORTED = {"stereo": False, "num_stems": 1, "linear_transformer_depth": 0,
               "attn_dropout": 0.0, "ff_dropout": 0.0, "stft_normalized": False}
ROPE_THETA = 10000.0
# the head width the rotary kernel takes
ROPE_KERNEL_DIM = 64

LAUNCHES: Dict[str, int] = {"rope_qk": 0}


class RMSNorm(nn.Module):
    """``F.normalize(x) * sqrt(dim) * gamma`` over the last axis (the
    norm's floor 1e-12)."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.scale = dim ** 0.5
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.normalize(x, dim=-1) * self.scale * self.gamma


class RotaryEmbedding(nn.Module):
    """``rotary_embedding_torch.RotaryEmbedding(dim)`` on positions
    0 .. n - 1: pair ``i`` of a head's channels (2 i, 2 i + 1) turns by
    ``pos * theta^(-2 i / dim)``. Holds no state: the angles are computed,
    once a length, device and dtype."""

    def __init__(self, dim: int, theta: float = ROPE_THETA) -> None:
        super().__init__()
        self.dim, self.theta = dim, theta
        self._cache: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def cos_sin(self, n: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin), each (n, dim), every angle repeated for its pair."""
        key = (n, str(like.device), like.dtype)
        got = self._cache.get(key)
        if got is None:
            kw = dict(device=like.device, dtype=like.dtype)
            freqs = 1.0 / self.theta ** (torch.arange(0, self.dim, 2, **kw) / self.dim)
            angles = (torch.arange(n, **kw)[:, None] * freqs).repeat_interleave(2, dim=-1)
            got = self._cache[key] = (angles.cos(), angles.sin())
        return got

    def rotate(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n, dim) queries or keys, rotated by their position."""
        cos, sin = self.cos_sin(x.shape[-2], x)
        return x * cos + rotate_half(x) * sin

    def rotate_qk(self, qkv: torch.Tensor, heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (S, n, 3 x heads x dim) output of a QKV projection -> its
        queries and keys, each (S, heads, n, dim), rotated by their
        position: the CUDA kernel on a CUDA tensor, ``rotate`` on each on a
        CPU one."""
        S, n, _ = qkv.shape
        if qkv.is_cuda:
            return rope_qk_cuda(qkv, *self.cos_sin(n, qkv), heads)
        q, k, _ = qkv.view(S, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
        return self.rotate(q), self.rotate(k)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1) -> (-x1, x0) on each interleaved pair of the last axis."""
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((-x2, x1), dim=-1).flatten(-2)


def rope_qk_cuda(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``RotaryEmbedding.rotate`` of the queries and of the keys of a QKV
    projection's (S, n, 3 x heads x 64) float32 output, contiguous on the
    card, by the (n, 64) ``cos`` and ``sin`` tables, in one launch of
    ``csrc/rope_qk.cu``: (q, k), each (S, heads, n, 64) contiguous, bit for
    bit the plain version's. Raises on anything the kernel does not take."""
    from musicfpaugment_torch import _build

    if not qkv.is_cuda or qkv.dtype != torch.float32 or qkv.dim() != 3:
        raise ValueError(f"the rotary kernel takes a 3-D float32 CUDA tensor, not a "
                         f"{qkv.dim()}-D {qkv.dtype} one on {qkv.device}")
    S, n, width = qkv.shape
    if width != 3 * heads * ROPE_KERNEL_DIM:
        raise ValueError(f"the rotary kernel takes heads of width {ROPE_KERNEL_DIM}: "
                         f"{width} is not 3 x {heads} x {ROPE_KERNEL_DIM}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("the rotary kernel takes the projection's output contiguous "
                         "and 16-byte aligned")
    for table in (cos, sin):
        if (table.device != qkv.device or table.dtype != torch.float32
                or tuple(table.shape) != (n, ROPE_KERNEL_DIM) or not table.is_contiguous()
                or table.data_ptr() % 16):
            raise ValueError(f"the rotary kernel takes ({n}, {ROPE_KERNEL_DIM}) float32 "
                             f"tables, contiguous and aligned, on the projection's device")
    out = torch.empty((2, S, heads, n, ROPE_KERNEL_DIM), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        status = _build.library().mfpa_rope_qk(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), S, n, heads,
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"rope_qk kernel launch failed: cudaError {status}")
    LAUNCHES["rope_qk"] += 1
    count("bsroformer.rope_launches", 1)
    # q and k read once and written once, and the two tables read
    count("bsroformer.rope_bytes", 4 * out.numel() * 2 + 4 * 2 * n * ROPE_KERNEL_DIM)
    return out[0], out[1]


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, rotary_embed: RotaryEmbedding) -> None:
        super().__init__()
        self.heads = heads
        inner = heads * dim_head
        self.rotary_embed = rotary_embed
        self.norm = RMSNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, bias=False), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(S, n, dim) -> (S, n, dim): ``S`` sequences of ``n`` tokens."""
        S, n, _ = x.shape
        qkv = self.to_qkv(self.norm(x))
        q, k = self.rotary_embed.rotate_qk(qkv, self.heads)
        v = qkv.view(S, n, 3, self.heads, -1)[:, :, 2].transpose(1, 2)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.to_out(out.transpose(1, 2).reshape(S, n, -1))


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4) -> None:
        super().__init__()
        self.net = nn.Sequential(RMSNorm(dim), nn.Linear(dim, dim * mult), nn.GELU(),
                                 nn.Identity(), nn.Linear(dim * mult, dim), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class Transformer(nn.Module):
    """``depth`` layers of ``x = attn(x) + x; x = ff(x) + x``; no output
    norm (the published ``norm_output=False``)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 rotary_embed: RotaryEmbedding) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([Attention(dim, heads, dim_head, rotary_embed), FeedForward(dim)])
            for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return x


class BandSplit(nn.Module):
    """(B, T, sum(dim_inputs)) -> (B, T, bands, dim): each band's slice
    through its own RMSNorm and linear layer."""

    def __init__(self, dim: int, dim_inputs: Sequence[int]) -> None:
        super().__init__()
        self.dim_inputs = tuple(dim_inputs)
        self.to_features = nn.ModuleList(nn.Sequential(RMSNorm(d), nn.Linear(d, dim))
                                         for d in self.dim_inputs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = x.split(self.dim_inputs, dim=-1)
        return torch.stack([f(p) for p, f in zip(parts, self.to_features)], dim=-2)


class MaskEstimator(nn.Module):
    """(B, T, bands, dim) -> (B, T, sum(dim_inputs)): each band's token
    through its own MLP (``depth`` linear layers, Tanh between them, the
    last to twice the band's width) and a GLU."""

    def __init__(self, dim: int, dim_inputs: Sequence[int], depth: int,
                 mlp_expansion_factor: int = 4) -> None:
        super().__init__()
        hidden = dim * mlp_expansion_factor
        self.to_freqs = nn.ModuleList()
        for d in dim_inputs:
            dims = (dim,) + (hidden,) * (depth - 1) + (2 * d,)
            layers = []
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
                layers.append(nn.Linear(a, b))
                if i < len(dims) - 2:
                    layers.append(nn.Tanh())
            self.to_freqs.append(nn.Sequential(nn.Sequential(*layers), nn.GLU(dim=-1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([mlp(band) for band, mlp in zip(x.unbind(dim=-2), self.to_freqs)], dim=-1)


class BSRoformer(nn.Module):
    """The published ``BSRoformer`` (keywords and defaults as there; see the
    module's docstring for what is left out)."""

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
                raise ValueError(f"BSRoformer: {key}={value!r} is not implemented "
                                 f"(only {UNSUPPORTED[key]!r})")
        freqs_per_bands = tuple(int(f) for f in freqs_per_bands)
        if sum(freqs_per_bands) != stft_n_fft // 2 + 1 or len(freqs_per_bands) < 2:
            raise ValueError(f"BSRoformer: the bands {freqs_per_bands} must be two or more and "
                             f"cover the {stft_n_fft // 2 + 1} bins of the STFT")
        self.n_fft, self.hop_length, self.win_length = stft_n_fft, stft_hop_length, stft_win_length
        time_rope, freq_rope = RotaryEmbedding(dim_head), RotaryEmbedding(dim_head)
        self.layers = nn.ModuleList(
            nn.ModuleList([Transformer(dim, time_transformer_depth, heads, dim_head, time_rope),
                           Transformer(dim, freq_transformer_depth, heads, dim_head, freq_rope)])
            for _ in range(depth))
        self.final_norm = RMSNorm(dim)
        dim_inputs = tuple(2 * f for f in freqs_per_bands)
        self.band_split = BandSplit(dim, dim_inputs)
        self.mask_estimators = nn.ModuleList(
            [MaskEstimator(dim, dim_inputs, mask_estimator_depth, mlp_expansion_factor)])
        # the Hann window per device and dtype, made once where it is used
        self._windows: Dict[Tuple, torch.Tensor] = {}

    def _window(self, like: torch.Tensor) -> torch.Tensor:
        key = (str(like.device), like.dtype)
        win = self._windows.get(key)
        if win is None:
            win = self._windows[key] = torch.hann_window(self.win_length, dtype=like.dtype,
                                                         device=like.device)
        return win

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """(B, N) -> (B, N), or (B, 1, N) -> (B, 1, N). In strict float32:
        cuBLAS's TF32 switch off."""
        if mix.dim() == 3 and mix.shape[1] != 1:
            raise ValueError(f"BSRoformer takes one audio channel, not {mix.shape[1]}")
        with matmul_tf32(False):
            out = self._forward(mix.reshape(mix.shape[0], mix.shape[-1]))
        return out.view(mix.shape)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N = x.shape
        stft = dict(n_fft=self.n_fft, hop_length=self.hop_length, win_length=self.win_length,
                    window=self._window(x), center=True, normalized=False)
        with annotate("bsroformer.stft"):
            z = torch.stft(x, return_complex=True, **stft)  # (B, bins, T)
            T = z.shape[-1]
            feats = torch.view_as_real(z).transpose(1, 2).reshape(B, T, -1)  # b t (f c)
        with annotate("bsroformer.band_split"):
            h = self.band_split(feats)
        K, D = h.shape[-2:]
        with annotate("bsroformer.transformer"):
            count("bsroformer.tokens", B * T * K)
            for time_transformer, freq_transformer in self.layers:
                h = time_transformer(h.transpose(1, 2).reshape(B * K, T, D))
                h = freq_transformer(h.view(B, K, T, D).transpose(1, 2).reshape(B * T, K, D))
                h = h.view(B, T, K, D)
        with annotate("bsroformer.mask"):
            mask = self.mask_estimators[0](self.final_norm(h))  # b t (f c)
            mask = torch.view_as_complex(mask.view(B, T, -1, 2)).transpose(1, 2)
            z = z * mask
        with annotate("bsroformer.istft"):
            return torch.istft(z, length=N, **stft)

"""audfprint landmark peak extraction (port of
musicfpaugment_tpu/afp/audfprint/peaks.py).

The frontends are tensor code. The forward and backward decaying-threshold
prunes exist twice: here as plain PyTorch column loops (the scan semantics of
the JAX ``forward_prune`` / ``backward_prune``), and as the CUDA kernels in
``peaks_cuda.py``. :func:`find_peaks_batch` picks by the tensor's device:
CUDA tensors go through the kernels, CPU tensors through the plain loops.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from musicfpaugment_torch.core.convolve import fft_convolve
from musicfpaugment_torch.core.stft import stft

NEG_INF = float("-inf")


# ------------------------------------------------------------ frontend


def _col_mask(shape, valid_frames: torch.Tensor) -> torch.Tensor:
    """(B, 1, C) boolean mask of columns < valid_frames[b]."""
    C = shape[-1]
    cols = torch.arange(C, device=valid_frames.device)
    return (cols[None, :] < valid_frames[:, None])[:, None, :]


def spectrogram_frontend(
    waveforms: torch.Tensor,
    n_fft: int = 512,
    n_hop: int = 256,
    valid_frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """|STFT| / per-example max, (B, n_fft//2 + 1, frames). Columns at or
    past ``valid_frames[b]`` are zeroed before the normalization."""
    sgram = torch.abs(stft(waveforms, n_fft=n_fft, hop_length=n_hop))
    if valid_frames is not None:
        sgram = torch.where(_col_mask(sgram.shape, valid_frames), sgram, 0.0)
    denom = torch.amax(sgram, dim=(-2, -1), keepdim=True)
    return sgram / torch.clamp(denom, min=torch.finfo(sgram.dtype).tiny)


def log_hpf_frontend(
    sgram: torch.Tensor, valid_frames: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """log + mean-subtract + per-row one-pole HPF (``lfilter([1,-1],
    [1,-0.98])`` as an FFT convolution of the first difference with the
    0.98^k kernel), Nyquist row dropped. With ``valid_frames`` the log-mean
    is taken over valid columns only."""
    sgrammax = torch.amax(sgram, dim=(-2, -1), keepdim=True)
    safe = torch.maximum(sgram, sgrammax / 1e6)
    logsg = torch.log(torch.where(sgrammax > 0, safe, 1.0))
    if valid_frames is None:
        logsg = logsg - torch.mean(logsg, dim=(-2, -1), keepdim=True)
    else:
        m = _col_mask(logsg.shape, valid_frames)
        F = logsg.shape[-2]
        tot = torch.sum(torch.where(m, logsg, 0.0), dim=(-2, -1), keepdim=True)
        cnt = (F * valid_frames).to(logsg.dtype)[:, None, None]
        logsg = logsg - tot / torch.clamp(cnt, min=1.0)
    n_cols = logsg.shape[-1]
    # first difference x[n] - x[n-1] with x[-1] = 0
    prev = torch.nn.functional.pad(logsg, (1, 0))[..., :-1]
    diff = logsg - prev
    kernel = torch.from_numpy(
        (0.98 ** np.arange(n_cols, dtype=np.float64)).astype(np.float32)
    ).to(logsg.device)
    filtered = fft_convolve(diff, kernel, mode="full")[..., :n_cols]
    return filtered[..., :-1, :]  # drop Nyquist row so bins fit in 8 bits


# ------------------------------------------------------------ peak pruning


@functools.lru_cache(maxsize=None)
def _gauss_table_np(npts: int, width: float) -> np.ndarray:
    """(npts, npts) table G[p, i] = exp(-0.5 ((i - p) / width)^2), float64
    math cast to float32. Row p depends only on |i - p|, so the CUDA kernels
    take its first row as a 1-D table."""
    d = np.arange(npts)[None, :] - np.arange(npts)[:, None]
    return np.exp(-0.5 * (d / width) ** 2).astype(np.float32)


def _locmax(v: torch.Tensor) -> torch.Tensor:
    """Local-max mask on the trailing axis: nbr[i] = v[i] >= v[i-1] with
    nbr[0] = True and nbr[n] = False, mask = nbr[:-1] & ~nbr[1:]."""
    up = v[..., 1:] >= v[..., :-1]
    one = torch.ones(v.shape[:-1] + (1,), dtype=torch.bool, device=v.device)
    nbr_prev = torch.cat([one, up], dim=-1)
    nbr_next = torch.cat([up, ~one], dim=-1)
    return nbr_prev & ~nbr_next


def _spread_init(v: torch.Tensor, gauss: torch.Tensor) -> torch.Tensor:
    """Initial envelope: max of Gaussians at the local maxima of v over a
    zero base. v: (B, F) -> (B, F)."""
    mask = _locmax(v)
    bumps = torch.where(mask[..., None], v[..., None] * gauss[None], NEG_INF)
    return torch.clamp(torch.amax(bumps, dim=-2), min=0.0)


def _top_k_lowest_first(vals: torch.Tensor, k: int):
    """``lax.top_k`` order: descending values, ties to the lower index."""
    top_vals, top_idx = torch.sort(vals, dim=-1, descending=True, stable=True)
    return top_vals[..., :k], top_idx[..., :k]


def forward_prune(
    sgram: torch.Tensor, a_dec: float, f_sd: float, maxpks: int
) -> torch.Tensor:
    """Plain forward decaying-threshold prune (a column loop).

    sgram: (B, F, C) log-HPF spectrogram. Returns a (B, F, C) bool mask."""
    B, F, C = sgram.shape
    gauss = torch.from_numpy(_gauss_table_np(F, f_sd)).to(sgram.device)
    sthresh = _spread_init(torch.amax(sgram[..., : min(10, C)], dim=-1), gauss)
    a = torch.tensor(a_dec, dtype=torch.float32)
    out = torch.zeros((B, F, C), dtype=torch.bool, device=sgram.device)
    rows = torch.arange(B, device=sgram.device)[:, None]
    for c in range(C):
        s_col = sgram[..., c]
        cand = _locmax(s_col) & (s_col > sthresh)
        vals = torch.where(cand, s_col, NEG_INF)
        top_vals, top_idx = _top_k_lowest_first(vals, maxpks)
        accept = top_vals > NEG_INF
        out[rows, top_idx, c] |= accept
        bumps = torch.where(
            accept[..., None], top_vals[..., None] * gauss[top_idx], NEG_INF
        )
        sthresh = torch.maximum(sthresh, torch.amax(bumps, dim=1)) * a
    return out


def backward_prune(
    sgram: torch.Tensor,
    peaks: torch.Tensor,
    a_dec: float,
    f_sd: float,
    maxpks: int,
    valid_frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain backward prune: columns right to left; each column's peaks are
    re-tested in descending order against the envelope raised by the larger
    kept peaks of the same column. A kept peak deletes a same-bin peak in the
    next column. With ``valid_frames`` the envelope starts from each row's
    last valid column and stays frozen across its padded columns."""
    B, F, C = sgram.shape
    dev = sgram.device
    gauss = torch.from_numpy(_gauss_table_np(F, f_sd)).to(dev)
    rows = torch.arange(B, device=dev)
    if valid_frames is None:
        sthresh = _spread_init(sgram[..., -1], gauss)
    else:
        last = sgram[rows, :, (valid_frames - 1).long()]  # (B, F)
        sthresh = _spread_init(last, gauss)
    a = torch.tensor(a_dec, dtype=torch.float32)
    kept_all = torch.zeros((B, F, C), dtype=torch.bool, device=dev)
    for c in range(C - 1, -1, -1):
        s_col = sgram[..., c]
        peaks_col = peaks[..., c]
        if valid_frames is not None:
            active_col = c < valid_frames  # (B,)
            peaks_col = peaks_col & active_col[:, None]
        vals = torch.where(peaks_col, s_col, NEG_INF)
        th = sthresh
        kept = torch.zeros((B, F), dtype=torch.bool, device=dev)
        for _ in range(maxpks):
            pos = torch.argmax(vals, dim=-1)  # first maximum
            val = vals[rows, pos]
            keep = (val > NEG_INF) & (val >= th[rows, pos])
            bump = torch.where(keep[:, None], val[:, None] * gauss[pos], NEG_INF)
            th = torch.maximum(th, bump)
            kept[rows, pos] |= keep
            vals[rows, pos] = NEG_INF
        th = th * a
        if valid_frames is not None:
            th = torch.where(active_col[:, None], th, sthresh)
        sthresh = th
        kept_all[..., c] = kept
    kill = torch.nn.functional.pad(kept_all, (1, 0))[..., :-1]
    return kept_all & ~kill


def prune_decay(density: float, n_hop: int) -> float:
    """Envelope decay per column (the reference's density rule)."""
    return float(1 - 0.01 * (density * np.sqrt(n_hop / 352.8) / 35))


def prune_input(
    waveforms: torch.Tensor,
    n_fft: int = 512,
    n_hop: int = 256,
    valid_frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T) waveforms -> the (B, n_fft//2, frames) float32 log-HPF
    spectrogram both prunes take; with ``valid_frames``, padded columns are
    driven to -1e30 so the forward pass admits no candidates there (its
    threshold is >= 0)."""
    sgram = spectrogram_frontend(waveforms, n_fft, n_hop, valid_frames)
    logsg = log_hpf_frontend(sgram, valid_frames)
    if valid_frames is not None:
        logsg = torch.where(_col_mask(logsg.shape, valid_frames), logsg, -1e30)
    return logsg.contiguous()


def find_peaks_batch(
    waveforms: torch.Tensor,
    density: float = 20.0,
    n_fft: int = 512,
    n_hop: int = 256,
    f_sd: float = 30.0,
    maxpksperframe: int = 5,
    valid_frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T) waveforms -> (B, n_fft//2, frames) bool peak masks.

    On a CUDA tensor both prunes run as the hand-written kernels of
    ``peaks_cuda.py`` (which raise if they cannot build or launch); on a CPU
    tensor they run as the plain loops above.

    ``valid_frames`` (B,) int32 enables mixed-length batches padded by
    ``analyzer.pad_waveform_batch``: columns at or past a row's count hold
    no peaks, and the backward pass starts each row's envelope from its last
    valid column.
    """
    logsg = prune_input(waveforms, n_fft, n_hop, valid_frames)
    a_dec = prune_decay(density, n_hop)
    if logsg.is_cuda:
        from musicfpaugment_torch.afp.audfprint.peaks_cuda import (
            backward_prune_cuda as bwd,
            forward_prune_cuda as fwd,
        )
    else:
        fwd, bwd = forward_prune, backward_prune
    if valid_frames is not None:
        colmask = _col_mask(logsg.shape, valid_frames)
        peaks = fwd(logsg, a_dec, f_sd, maxpksperframe)
        kept = bwd(logsg, peaks & colmask, a_dec, f_sd, maxpksperframe, valid_frames)
        return kept & colmask
    peaks = fwd(logsg, a_dec, f_sd, maxpksperframe)
    return bwd(logsg, peaks, a_dec, f_sd, maxpksperframe)

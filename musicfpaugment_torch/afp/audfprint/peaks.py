"""audfprint landmark peak extraction (port of
musicfpaugment_tpu/afp/audfprint/peaks.py).

The frontends are tensor code. The forward and backward decaying-threshold
prunes exist twice: here as plain PyTorch column loops (the scan semantics of
the JAX ``forward_prune`` / ``backward_prune``), and as the CUDA kernels in
``peaks_cuda.py``. :func:`find_peaks_batch` and :func:`find_peaks_parts`
pick by the tensor's device: CUDA tensors go through the kernels on a
time-major spectrogram, CPU tensors through the plain loops.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

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
    time_major: bool = False,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T) waveforms -> the (B, n_fft//2, frames) float32 log-HPF
    spectrogram both prunes take; with ``valid_frames``, padded columns are
    driven to -1e30 so the forward pass admits no candidates there (its
    threshold is >= 0).

    ``time_major`` gives the same values as (B, frames, n_fft//2), the
    layout of the CUDA kernels: the transpose rides the one copy that drops
    the Nyquist row and fills the padded columns. ``out`` (of the result's
    shape, possibly a strided slice of a larger batch) receives that copy."""
    sgram = spectrogram_frontend(waveforms, n_fft, n_hop, valid_frames)
    logsg = log_hpf_frontend(sgram, valid_frames)
    mask = None if valid_frames is None else _col_mask(logsg.shape, valid_frames)
    if time_major:
        logsg = logsg.transpose(1, 2)
        mask = None if mask is None else mask.transpose(1, 2)
    if out is None:
        out = torch.empty(logsg.shape, dtype=logsg.dtype, device=logsg.device)
    if mask is None:
        out.copy_(logsg)
    else:
        torch.where(mask, logsg, logsg.new_tensor(-1e30), out=out)
    return out


def stacked_prune_input(
    parts: Sequence[torch.Tensor],
    n_fft: int = 512,
    n_hop: int = 256,
    valid_frames: Optional[Sequence[Optional[torch.Tensor]]] = None,
    time_major: bool = False,
):
    """:func:`prune_input` of several (B, T_s) waveform batches, stacked
    along the batch axis into one (S*B, F, frames) tensor ((S*B, frames, F)
    with ``time_major``) as wide as the longest part: each part's frontend
    writes its slice, columns past a part's own count are -1e30, and each
    row's valid frame count is its part's (``valid_frames[s]`` where given).
    Returns (stack, (S*B,) int32 valid frames, [frames_s]). A single part
    is not padded and keeps its ``valid_frames`` (possibly ``None``)."""
    S, B = len(parts), parts[0].shape[0]
    vfs = list(valid_frames) if valid_frames is not None else [None] * S
    n_cols = [1 + int(p.shape[-1]) // n_hop for p in parts]
    if S == 1:
        return prune_input(parts[0], n_fft, n_hop, vfs[0], time_major), vfs[0], n_cols
    dev = parts[0].device
    wide, F = max(n_cols), n_fft // 2
    shape = (S * B, wide, F) if time_major else (S * B, F, wide)
    x = torch.empty(shape, dtype=torch.float32, device=dev)
    cols = x if time_major else x.transpose(1, 2)  # (S*B, wide, F) either way
    vf = torch.empty((S * B,), dtype=torch.int32, device=dev)
    for s, part in enumerate(parts):
        rows = slice(s * B, (s + 1) * B)
        dst = cols[rows, : n_cols[s]]
        prune_input(
            part, n_fft, n_hop, vfs[s], time_major,
            out=dst if time_major else dst.transpose(1, 2),
        )
        cols[rows, n_cols[s] :] = -1e30
        vf[rows] = n_cols[s] if vfs[s] is None else vfs[s]
    return x, vf, n_cols


def find_peaks_parts(
    parts: Sequence[torch.Tensor],
    density: float = 20.0,
    n_fft: int = 512,
    n_hop: int = 256,
    f_sd: float = 30.0,
    maxpksperframe: int = 5,
    valid_frames: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> List[torch.Tensor]:
    """Peak masks of several (B, T_s) waveform batches (the time shifts of
    one batch) with one forward and one backward prune for all of them,
    over :func:`stacked_prune_input`: the mechanism of a mixed-length batch.
    Returns S (B, n_fft//2, frames_s) bool masks, equal to pruning each part
    on its own.

    On CUDA tensors the stack is time-major, both prunes are the kernels of
    ``peaks_cuda.py`` (which raise if they cannot build or launch) and the
    masks are views of the backward kernel's output. There the masking by
    column of the CPU route is not needed: the forward kernel admits no
    candidate in a -1e30 column (its envelope is >= 0), and the backward
    kernel reads no column at or past ``valid_frames[b]`` and writes zeros
    there. On CPU tensors the prunes are the plain loops above."""
    B = parts[0].shape[0]
    on_card = parts[0].is_cuda
    x, vf, n_cols = stacked_prune_input(parts, n_fft, n_hop, valid_frames, on_card)
    a_dec = prune_decay(density, n_hop)
    if on_card:
        from musicfpaugment_torch.afp.audfprint import peaks_cuda

        peaks = peaks_cuda.forward_prune_tm(x, a_dec, f_sd, maxpksperframe)
        kept = peaks_cuda.backward_prune_tm(x, peaks, a_dec, f_sd, maxpksperframe, vf)
        masks = peaks_cuda.as_bool_masks(kept)
    else:
        peaks = forward_prune(x, a_dec, f_sd, maxpksperframe)
        if vf is None:
            masks = backward_prune(x, peaks, a_dec, f_sd, maxpksperframe)
        else:
            colmask = _col_mask(x.shape, vf)
            kept = backward_prune(x, peaks & colmask, a_dec, f_sd, maxpksperframe, vf)
            masks = kept & colmask
    if len(parts) == 1:
        return [masks]
    return [masks[s * B : (s + 1) * B, :, :c] for s, c in enumerate(n_cols)]


def find_peaks_shifts(
    waveforms: torch.Tensor,
    shifts: int,
    density: float = 20.0,
    n_fft: int = 512,
    n_hop: int = 256,
    f_sd: float = 30.0,
    maxpksperframe: int = 5,
    valid_samples: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    """Peak masks of ``shifts`` time-shifted copies of one (B, T) batch,
    shift s dropping ``int(s / shifts * n_hop)`` leading samples, through
    :func:`find_peaks_parts` (one launch of each prune for all shifts).
    ``valid_samples`` (B,) marks real lengths of a batch stacked by
    ``analyzer.pad_waveform_batch``; each shift's valid frame count is
    ``1 + (valid_samples - offset) // n_hop``."""
    n_shifts = max(1, shifts)
    offsets = [int(s / n_shifts * n_hop) for s in range(n_shifts)]
    vfs = None
    if valid_samples is not None:
        vfs = [1 + (valid_samples - off) // n_hop for off in offsets]
    return find_peaks_parts(
        [waveforms[:, off:] for off in offsets],
        density, n_fft, n_hop, f_sd, maxpksperframe, vfs,
    )


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
    ``peaks_cuda.py`` (which raise if they cannot build or launch) on the
    time-major spectrogram, and the result is a bool view of the backward
    kernel's (B, frames, n_fft//2) output; on a CPU tensor they run as the
    plain loops above.

    ``valid_frames`` (B,) int32 enables mixed-length batches padded by
    ``analyzer.pad_waveform_batch``: columns at or past a row's count hold
    no peaks, and the backward pass starts each row's envelope from its last
    valid column.
    """
    return find_peaks_parts(
        [waveforms], density, n_fft, n_hop, f_sd, maxpksperframe,
        None if valid_frames is None else [valid_frames],
    )[0]


# ------------------------------------------------ the kernels' argmax, stated


def float_order_key(x: np.ndarray) -> np.ndarray:
    """float32 -> uint32 key whose unsigned order is the float order, as the
    CUDA kernels form it: 0.0 is added first (so -0.0 and +0.0 share a key),
    then a negative has all bits flipped and a non-negative its top bit set.
    -inf gets the lowest key in use, 0x007fffff; the kernels keep 0 for "no
    candidate". A positive float's key is its own bits with the top bit set,
    so the forward kernel, whose candidates are all positive, compares the
    bits themselves."""
    u = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)
    top = np.uint32(0x80000000)
    return np.where(u & top, ~u, u | top).astype(np.uint32)


def float_from_key(key: np.ndarray) -> np.ndarray:
    """Inverse of :func:`float_order_key`: the float's own bits (+0.0 for
    either zero)."""
    key = np.asarray(key, np.uint32)
    top = np.uint32(0x80000000)
    return np.where(key & top, key ^ top, ~key).astype(np.uint32).view(np.float32)


def argmax_by_key(vals: np.ndarray, lanes: int = 32):
    """Row-wise argmax of (..., F) float32 the way a warp of the kernels
    takes it: lane l holds bins [l*NB, (l+1)*NB), NB = F / lanes, and keeps
    its best key with ties to its lower bin; one reduction takes the warp's
    maximum key, a second the lowest bin among the lanes that hold it.
    Returns (position, value): the first maximum, as ``torch.argmax`` and
    ``lax.top_k`` give it."""
    keys = float_order_key(vals)
    lead, F = keys.shape[:-1], keys.shape[-1]
    nb = F // lanes
    per_lane = keys.reshape(*lead, lanes, nb)
    best = per_lane.max(axis=-1)
    # first maximum in the lane: its lower bin
    mypos = np.arange(lanes) * nb + per_lane.argmax(axis=-1)
    top = best.max(axis=-1)
    pos = np.where(best == top[..., None], mypos, np.iinfo(np.int32).max).min(axis=-1)
    return pos, float_from_key(top)

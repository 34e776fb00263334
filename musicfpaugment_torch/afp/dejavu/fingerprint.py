"""Dejavu fingerprinting: max-filter peak picking on the device, SHA1
hashing on the host (port of musicfpaugment_tpu/afp/dejavu/fingerprint.py).

The scipy ``maximum_filter`` / ``binary_erosion`` peak detector of the
original Dejavu becomes two separable ``max_pool2d`` passes (max with -inf
padding; the erosion as a max over the non-background with the same
padding), batched over queries behind a cuFFT PSD spectrogram. Hash
generation (SHA1 of "f1|f2|dt") stays on the host; the integer-packed hash
of :func:`pack_hashes` / :func:`pack_hashes_from_masks` serves the device
matcher. Masks from the same log spectrogram are bit-identical to the JAX
package's (max and AND are exact).

The denoiser is an injected callable, as in the JAX package.
"""

from __future__ import annotations

import functools
import hashlib
from operator import itemgetter
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from musicfpaugment_torch.afp.audfprint.landmarks import compact_valid_first
from musicfpaugment_torch.afp.dejavu.variables import (
    CONNECTIVITY_MASK,
    FINGERPRINT_REDUCTION,
    MAX_HASH_TIME_DELTA,
    MIN_HASH_TIME_DELTA,
    PEAK_NEIGHBORHOOD_SIZE,
)
from musicfpaugment_torch.afp.denoising import (
    DEJAVU_ORDER,
    SPECTROGRAM_DENOISERS,
    check_denoising_model,
)
from musicfpaugment_torch.core.stft import frame
from musicfpaugment_torch.device import DeviceLike, resolve_device

DEFAULT_SETTINGS = {
    "samplerate": 8000,
    "n_fft": 512,
    "n_hop": 256,
    "fan_value": 3,
    "amp_min": 50,
    "peak_neighb_size": PEAK_NEIGHBORHOOD_SIZE,
}

# key of an invalid hash slot: above every packed key, so it sorts last
INVALID_KEY = 1 << 30


@functools.lru_cache(maxsize=None)
def _sym_hann(n: int) -> np.ndarray:
    """matplotlib ``mlab.window_hanning``: the symmetric ``np.hanning``."""
    return np.hanning(n).astype(np.float32)


def specgram_psd(
    signal: torch.Tensor, fs: float = 8000, n_fft: int = 512, noverlap: int = 256
) -> torch.Tensor:
    """``mlab.specgram`` one-sided PSD: symmetric Hann, no centre padding,
    |rfft|^2 / (fs * sum(win^2)), every bin but DC and Nyquist doubled.
    ``(..., T)`` -> ``(..., n_fft // 2 + 1, frames)`` on the input's device."""
    win_np = _sym_hann(n_fft)
    win = torch.from_numpy(win_np).to(signal.device)
    frames = frame(signal, n_fft, n_fft - noverlap)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    psd = spec.abs() ** 2 / (fs * float(np.sum(win_np**2)))
    scale = np.full(n_fft // 2 + 1, 2.0, np.float32)
    scale[0] = scale[-1] = 1.0
    psd = psd * torch.from_numpy(scale).to(signal.device)
    return psd.transpose(-1, -2)


def _square_footprint_size(neighborhood: int, connectivity: int) -> int:
    """``iterate_structure(generate_binary_structure(2, 2), n)`` is the full
    (2n+1) x (2n+1) square for connectivity 2."""
    if connectivity != 2:
        raise ValueError("only the square (connectivity-2) footprint is used")
    return 2 * neighborhood + 1


def _window_max(x: torch.Tensor, k: int) -> torch.Tensor:
    """Max over the k x k square around each cell of a (N, 1, F, C) float
    tensor, as two separable passes; ``max_pool2d`` pads with -inf."""
    x = F.max_pool2d(x, (k, 1), stride=1, padding=(k // 2, 0))
    return F.max_pool2d(x, (1, k), stride=1, padding=(0, k // 2))


def detect_peaks_mask(
    arr: torch.Tensor,
    amp_min: float = 50.0,
    neighborhood: int = PEAK_NEIGHBORHOOD_SIZE,
    connectivity: int = CONNECTIVITY_MASK,
) -> torch.Tensor:
    """Boolean peak mask of (..., F, C) log spectrograms.

    local_max: the value equals the max of its (2n+1)^2 window (-inf
    padding). eroded: every cell of the window is background (== 0), the
    padding counting as background (scipy's ``border_value=1``): the max of
    the non-background indicator over the window is 0. Peaks are
    ``local_max != eroded`` above ``amp_min``."""
    k = _square_footprint_size(neighborhood, connectivity)
    planes = arr.reshape((-1, 1) + tuple(arr.shape[-2:]))
    local_max = _window_max(planes, k).reshape(arr.shape) == arr
    foreground = (planes != 0).to(planes.dtype)
    eroded = (_window_max(foreground, k) == 0).reshape(arr.shape)
    return (local_max != eroded) & (arr > amp_min)


def fingerprint_spectrogram_batch(
    waveforms: torch.Tensor,
    fs: float = 8000,
    wsize: int = 512,
    n_hop: int = 256,
    amp_min: float = 50.0,
    denoiser: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """(B, T) waveforms -> (log spectrograms (B, F, C), peak masks (B, F, C),
    normalised PSD spectrograms (B, F, C)), on the input's device.

    PSD -> / max -> [``denoiser(x) ** 2``] -> 10 ln(max(a, max / 1e6)) (the
    natural log, as the original Dejavu) -> minus the per-example mean ->
    peak detection."""
    arr2d = specgram_psd(waveforms, fs, wsize, wsize - n_hop)
    denom = torch.amax(arr2d, dim=(-2, -1), keepdim=True)
    arr2d = arr2d / torch.clamp(denom, min=torch.finfo(arr2d.dtype).tiny)
    if denoiser is not None:
        arr2d = denoiser(arr2d) ** 2
    specgram = arr2d
    amax = torch.amax(arr2d, dim=(-2, -1), keepdim=True)
    logd = 10.0 * torch.log(torch.maximum(arr2d, amax / 1e6))
    logd = logd - torch.mean(logd, dim=(-2, -1), keepdim=True)
    mask = detect_peaks_mask(logd, amp_min=amp_min)
    return logd, mask, specgram


def get_2D_peaks(
    arr2D,
    plot: bool = False,
    amp_min: float = 50,
    device: DeviceLike = None,
) -> Tuple[List[Tuple[int, int]], np.ndarray]:
    """One spectrogram's peaks, the original signature: ([(freq, time),
    ...], mask as float64). The detector runs on ``device``."""
    arr = torch.as_tensor(np.asarray(arr2D, np.float32), device=resolve_device(device))
    mask = detect_peaks_mask(arr, amp_min=amp_min).cpu().numpy()
    return peaks_from_mask(mask), mask.astype(np.float64)


def peaks_from_mask(mask: np.ndarray) -> List[Tuple[int, int]]:
    """(F, C) mask -> [(freq, time), ...] in ``np.nonzero`` order."""
    freqs, times = np.nonzero(np.asarray(mask))
    return list(zip(freqs.tolist(), times.tolist()))


def generate_hashes(
    peaks: List[Tuple[int, int]], fan_value: int = 3
) -> List[Tuple[str, int]]:
    """SHA1 landmark hashes: each peak, in time order, pairs with its
    ``fan_value - 1`` successors whose time delta lies in
    [MIN_HASH_TIME_DELTA, MAX_HASH_TIME_DELTA]."""
    idx_freq = 0
    idx_time = 1
    peaks = list(peaks)
    peaks.sort(key=itemgetter(1))
    hashes = []
    for i in range(len(peaks)):
        for j in range(1, fan_value):
            if (i + j) < len(peaks):
                freq1 = peaks[i][idx_freq]
                freq2 = peaks[i + j][idx_freq]
                t1 = peaks[i][idx_time]
                t2 = peaks[i + j][idx_time]
                t_delta = t2 - t1
                if MIN_HASH_TIME_DELTA <= t_delta <= MAX_HASH_TIME_DELTA:
                    h = hashlib.sha1(
                        f"{str(freq1)}|{str(freq2)}|{str(t_delta)}".encode("utf-8")
                    )
                    hashes.append((h.hexdigest()[0:FINGERPRINT_REDUCTION], t1))
    return hashes


def pack_hashes(
    peaks: List[Tuple[int, int]], fan_value: int = 3
) -> List[Tuple[int, int]]:
    """Integer-packed :func:`generate_hashes`: ``(f1 << 17) | (f2 << 8) |
    dt`` (26 bits for f < 512, dt < 256), a bijection of the triple the SHA1
    string encodes, so match sets are the same."""
    peaks = sorted(peaks, key=itemgetter(1))
    out = []
    for i in range(len(peaks)):
        for j in range(1, fan_value):
            if (i + j) < len(peaks):
                f1, t1 = peaks[i]
                f2, t2 = peaks[i + j]
                dt = t2 - t1
                if MIN_HASH_TIME_DELTA <= dt <= MAX_HASH_TIME_DELTA:
                    out.append(((int(f1) << 17) | (int(f2) << 8) | int(dt), t1))
    return out


def _shift_left(x: torch.Tensor, j: int, fill) -> torch.Tensor:
    """Row shift: slot i holds x[:, i + j], the last j slots ``fill``."""
    return torch.cat([x[:, j:], torch.full_like(x[:, :j], fill)], dim=1)


def pack_hashes_from_masks(
    masks: torch.Tensor, max_peaks: int, fan_value: int = 3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched :func:`pack_hashes` of (B, F, C) peak masks, deduplicated by
    (key, t1), on the masks' device.

    Peaks are taken in (time, freq) order, which is ``np.nonzero``'s order
    after the stable time sort of :func:`generate_hashes`; the first
    ``max_peaks`` of each row are kept. The dedup is the ``set()`` of the
    host path, done by one sort of the composite int64 key ``(key << 32) |
    t1``; invalid slots hold :data:`INVALID_KEY` and sort last.

    Returns ``(keys, t1, valid, key_first, n_distinct, n_peak_overflow)``:
    (B, H = max_peaks * (fan_value - 1)) int32 keys and times sorted by
    (key, t1), the valid (first of each (key, t1)) and the first-of-each-key
    masks, the (B,) int32 count of distinct hashes, and the number of rows
    whose peaks exceeded ``max_peaks``."""
    B, F_, C = masks.shape
    # the 26-bit key only encodes f2 < 512 and dt < 256 without overlap
    if F_ > 512:
        raise ValueError(
            f"packed dejavu keys require <= 512 frequency bins, got {F_} "
            "(n_fft too large for the 26-bit key layout)"
        )
    if MAX_HASH_TIME_DELTA > 255:
        raise ValueError(
            "packed dejavu keys require MAX_HASH_TIME_DELTA <= 255, got "
            f"{MAX_HASH_TIME_DELTA}"
        )
    dev = masks.device
    m = masks.transpose(-1, -2).reshape(B, C * F_)  # row-major = (t, f)
    flat = torch.arange(C * F_, dtype=torch.int32, device=dev)
    tpos = (flat // F_).expand(B, -1)
    fpos = (flat % F_).expand(B, -1)
    pt, pf, npk = compact_valid_first(tpos, fpos, m, out_len=max_peaks)
    n_peak_overflow = (npk > max_peaks).sum(dtype=torch.int32)
    vpk = torch.arange(max_peaks, device=dev)[None, :] < torch.clamp(npk, max=max_peaks)[:, None]

    key_parts, t_parts = [], []
    for j in range(1, fan_value):
        f2 = _shift_left(pf, j, 0)
        dt = _shift_left(pt, j, 0) - pt  # >= 0 in (t, f) order
        ok = (
            vpk
            & _shift_left(vpk, j, False)
            & (dt >= MIN_HASH_TIME_DELTA)
            & (dt <= MAX_HASH_TIME_DELTA)
        )
        key_parts.append(torch.where(ok, (pf << 17) | (f2 << 8) | dt, INVALID_KEY))
        t_parts.append(pt)
    keys = torch.cat(key_parts, dim=1).long()
    t1 = torch.cat(t_parts, dim=1).long()
    packed = torch.sort((keys << 32) | t1, dim=-1).values
    skey = (packed >> 32).to(torch.int32)
    st = (packed & 0xFFFFFFFF).to(torch.int32)
    in_range = skey < INVALID_KEY
    prev = torch.cat([torch.full_like(packed[:, :1], -1), packed[:, :-1]], dim=1)
    valid = in_range & (packed != prev)
    key_first = valid & (skey != (prev >> 32).to(torch.int32))
    n_distinct = valid.sum(dim=-1, dtype=torch.int32)
    return skey, st, valid, key_first, n_distinct, n_peak_overflow


def fingerprint(
    channel_samples,
    Fs: float = 8000,
    wsize: int = 512,
    n_hop: int = 256,
    fan_value: int = 3,
    amp_min: float = 50,
    denoising: bool = False,
    denoising_model: str = "unet",
    denoiser: Optional[Callable] = None,
    get_masks: bool = False,
    device: DeviceLike = None,
):
    """One channel's SHA1 hashes (and with ``get_masks=True`` also its peak
    mask as float64 and its normalised PSD spectrogram, as numpy); the
    spectrogram and peaks run on ``device``. ``denoiser`` is the UNet hook,
    used when ``denoising`` with ``denoising_model="unet"``."""
    if denoising:
        check_denoising_model(denoising_model, DEJAVU_ORDER)
    x = torch.as_tensor(
        np.asarray(channel_samples, np.float32), device=resolve_device(device)
    )[None, :]
    hook = denoiser if (denoising and denoising_model in SPECTROGRAM_DENOISERS) else None
    _, mask, specgram = fingerprint_spectrogram_batch(
        x, Fs, wsize, n_hop, amp_min, denoiser=hook
    )
    mask_np = mask[0].cpu().numpy()
    hashes = generate_hashes(peaks_from_mask(mask_np), fan_value=fan_value)
    if get_masks is True:
        return hashes, mask_np.astype(np.float64), specgram[0].cpu().numpy()
    return hashes

"""Audfprint analyzer, batched path (port of
musicfpaugment_tpu/afp/audfprint/analyzer.py).

:class:`AudfprintPeaks` turns batches of waveforms into peak masks and
(time, hash) landmarks on its device, and ingests them into a host
:class:`HashTable`. Inputs are arrays, tensors or ``.npy`` files; WAV/pkl
decoding and the denoiser hooks are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint import landmarks as lm
from musicfpaugment_torch.afp.audfprint.hash_table import HashTable
from musicfpaugment_torch.afp.audfprint.peaks import find_peaks_batch, find_peaks_shifts
from musicfpaugment_torch.device import DeviceLike, resolve_device

Waveform = Union[np.ndarray, torch.Tensor]


def pad_waveform_batch(
    waveforms: Sequence[Waveform],
    n_fft: int = 512,
    pad_to: Optional[int] = None,
    device: DeviceLike = "cpu",
) -> Tuple[torch.Tensor, np.ndarray]:
    """Stack mixed-length 1-D waveforms into one (B, T + n_fft//2) batch on
    ``device``.

    Each waveform is extended by ``n_fft // 2`` reflected samples (what the
    STFT's centered reflect padding reads past the end) and then zeros, so
    frames below each example's valid count equal the unpadded computation.
    Returns (batch, valid_samples) with ``valid_samples[b]`` the original
    length."""
    half = n_fft // 2
    lens = [int(w.shape[-1]) for w in waveforms]
    for L in lens:
        if L <= half:
            raise ValueError(
                f"waveform of {L} samples is shorter than n_fft/2={half}; "
                "mixed-length batching needs a reflectable tail"
            )
    T = pad_to if pad_to is not None else max(lens)
    out = torch.zeros((len(lens), T + half), dtype=torch.float32, device=device)
    for i, w in enumerate(waveforms):
        w = torch.as_tensor(w, dtype=torch.float32, device=device).reshape(-1)
        L = lens[i]
        out[i, :L] = w
        out[i, L : L + half] = torch.flip(w[L - 1 - half : L - 1], dims=[0])
    return out, np.asarray(lens, np.int32)


def valid_frames_for(
    valid_samples, shift_samples: int = 0, n_fft: int = 512, n_hop: int = 256
):
    """Per-example valid frame count of a centered STFT over the first
    ``valid_samples - shift_samples`` samples: ``1 + floor(L / n_hop)``."""
    del n_fft  # centered: the pad cancels the window length
    return 1 + (valid_samples - shift_samples) // n_hop


class AudfprintPeaks:
    """Analysis of waveforms into hash constellations on ``device``
    (``None`` = CUDA; raises without it unless ``device="cpu"``)."""

    def __init__(self, params: Dict[str, Any], device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.density = params["density"]
        self.target_sr = params["samplerate"]
        self.n_fft = params["n_fft"]
        self.n_hop = params["n_hop"]
        self.shifts = params["shifts"]
        self.f_sd = params["freq-sd"]
        self.maxpksperframe = params["pks-per-frame"]

    def _as_batch(self, waveforms: Waveform) -> torch.Tensor:
        return torch.as_tensor(waveforms, dtype=torch.float32, device=self.device)

    def peaks_batch(
        self, waveforms: Waveform, valid_frames: Optional[np.ndarray] = None
    ) -> torch.Tensor:
        """(B, T) waveforms -> (B, n_fft//2, frames) bool peak masks.
        ``valid_frames`` marks per-example frame counts of mixed-length
        batches (see :func:`pad_waveform_batch`)."""
        vf = None
        if valid_frames is not None:
            vf = torch.as_tensor(valid_frames, dtype=torch.int32, device=self.device)
        return find_peaks_batch(
            self._as_batch(waveforms),
            density=self.density,
            n_fft=self.n_fft,
            n_hop=self.n_hop,
            f_sd=self.f_sd,
            maxpksperframe=self.maxpksperframe,
            valid_frames=vf,
        )

    def hashes_from_masks(self, masks: torch.Tensor):
        """(B, F, C) masks -> ((B, max_hashes, 2) int32, (B, max_hashes)
        bool), with the static pads of the JAX package: <= maxpksperframe
        peaks per column rounded up to 128, 3 pairs per peak."""
        C = int(masks.shape[-1])
        max_peaks = -(-self.maxpksperframe * C // 128) * 128
        return lm.hashes_from_masks_batched(
            masks, max_peaks=max_peaks, max_hashes=max_peaks * lm.MAXPAIRSPERPEAK
        )

    def hashes_batch(
        self,
        waveforms: Waveform,
        shifts: Optional[int] = None,
        valid_samples: Optional[np.ndarray] = None,
    ) -> List[np.ndarray]:
        """(B, T) waveforms -> list of B (N_i, 2) unique sorted (time, hash)
        int32 arrays. Shift s drops ``int(s / shifts * n_hop)`` leading
        samples; all shifts are pruned as one stacked batch; the cross-shift
        dedup is a host ``np.unique``."""
        waveforms = self._as_batch(waveforms)
        n_shifts = max(1, shifts if shifts is not None else self.shifts)
        vsamp = None
        if valid_samples is not None:
            vsamp = torch.as_tensor(
                np.asarray(valid_samples, np.int32), device=self.device
            )
        # every shift's peaks from one forward and one backward prune
        masks_by_shift = find_peaks_shifts(
            waveforms,
            n_shifts,
            density=self.density,
            n_fft=self.n_fft,
            n_hop=self.n_hop,
            f_sd=self.f_sd,
            maxpksperframe=self.maxpksperframe,
            valid_samples=vsamp,
        )
        per_shift = []  # per shift: B arrays of (N, 2)
        for masks in masks_by_shift:
            th, valid = self.hashes_from_masks(masks)
            th, valid = th.cpu().numpy(), valid.cpu().numpy()
            per_shift.append([t[v] for t, v in zip(th, valid)])
        out = []
        for b in range(waveforms.shape[0]):
            allh = np.concatenate([s[b] for s in per_shift], axis=0)
            if allh.shape[0] == 0:
                out.append(allh.astype(np.int32).reshape(0, 2))
                continue
            packed = (allh[:, 0].astype(np.uint64) << np.uint64(32)) + allh[
                :, 1
            ].astype(np.uint64)
            uniq = np.unique(packed)
            out.append(
                np.stack(
                    [uniq >> np.uint64(32), uniq & np.uint64(0xFFFFFFFF)], axis=1
                ).astype(np.int32)
            )
        return out

    def _load(self, source: Union[str, Waveform]) -> Waveform:
        """One mono waveform from an array, a tensor (kept on its device) or
        a ``.npy`` file."""
        if isinstance(source, torch.Tensor):
            return source.to(torch.float32).reshape(-1)
        if isinstance(source, np.ndarray):
            return source.astype(np.float32).reshape(-1)
        if str(source).endswith(".npy"):
            return np.load(source).astype(np.float32).reshape(-1)
        raise ValueError(f"cannot decode {source!r}: only arrays and .npy files")

    def ingest_batch(
        self,
        hashtable: HashTable,
        names: List[str],
        waveforms: Waveform,
        shifts: Optional[int] = 1,
        valid_samples: Optional[np.ndarray] = None,
    ) -> int:
        """Peaks and hashes for the whole batch on the device, then one
        vectorized host store per track. Returns the number of hashes."""
        all_hashes = self.hashes_batch(
            waveforms, shifts=shifts, valid_samples=valid_samples
        )
        total = 0
        for name, hashes in zip(names, all_hashes):
            hashtable.store(name, hashes)
            total += len(hashes)
        return total

"""Audfprint analyzer (port of musicfpaugment_tpu/afp/audfprint/analyzer.py).

:class:`AudfprintPeaks` turns batches of waveforms into peak masks and
(time, hash) landmarks on its device, and ingests them into a host
:class:`HashTable`; ``find_peaks`` / ``wavfile2peaks`` / ``wavfile2hashes`` /
``ingest`` keep the one-file signatures. Inputs are arrays, tensors or
``.npy``, ``.pkl`` and ``.wav`` files. Denoisers are injected as callables
on tensors: ``spec_denoiser`` (B, F, C) -> (B, F, C) on the normalised
magnitude (``convert.unet_denoiser``), ``wave_denoiser`` (B, T) -> (B, T)
on the waveforms before the peaks.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint import landmarks as lm
from musicfpaugment_torch.afp.audfprint.hash_table import HashTable
from musicfpaugment_torch.afp.audfprint.matcher import locmax
from musicfpaugment_torch.afp.audfprint.peaks import find_peaks_batch, find_peaks_shifts
from musicfpaugment_torch.afp.denoising import (
    SPECTROGRAM_DENOISERS,
    WAVEFORM_DENOISERS,
    check_denoising_model,
)
from musicfpaugment_torch.augment.constants import WAVEFORM_SAMPLING_RATE
from musicfpaugment_torch.data.audio_io import read_wav, resample
from musicfpaugment_torch.device import DeviceLike, resolve_device
from musicfpaugment_torch.utils.profiling import annotate

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

    def __init__(
        self,
        params: Dict[str, Any],
        denoising: bool = False,
        denoising_model: Optional[str] = None,
        spec_denoiser: Optional[Callable] = None,
        wave_denoiser: Optional[Callable] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.density = params["density"]
        self.target_sr = params["samplerate"]
        self.n_fft = params["n_fft"]
        self.n_hop = params["n_hop"]
        self.shifts = params["shifts"]
        self.f_sd = params["freq-sd"]
        self.maxpksperframe = params["pks-per-frame"]
        self.maxpairsperpeak = lm.MAXPAIRSPERPEAK
        self.mindt = lm.MINDT
        self.targetdt = lm.TARGETDT
        self.targetdf = lm.TARGETDF
        self.denoising = denoising
        self.denoising_model = denoising_model
        if self.denoising:
            check_denoising_model(denoising_model)
            if denoising_model in SPECTROGRAM_DENOISERS and spec_denoiser is None:
                raise ValueError(f"{denoising_model} denoising requires spec_denoiser")
            if denoising_model in WAVEFORM_DENOISERS and wave_denoiser is None:
                raise ValueError(f"{denoising_model} denoising requires wave_denoiser")
        self.spec_denoiser = spec_denoiser
        self.wave_denoiser = wave_denoiser
        self.soundfiledur = 0.0

    def _spec_hook(self) -> Optional[Callable]:
        """The spectrogram denoiser, if this analyzer denoises with one."""
        if self.denoising and self.denoising_model in SPECTROGRAM_DENOISERS:
            return self.spec_denoiser
        return None

    def _as_batch(self, waveforms: Waveform) -> torch.Tensor:
        """The batch on the analyzer's device, through the waveform
        denoiser if this analyzer denoises with one."""
        batch = torch.as_tensor(waveforms, dtype=torch.float32, device=self.device)
        if self.denoising and self.denoising_model in WAVEFORM_DENOISERS:
            batch = self.wave_denoiser(batch)
        return batch

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
            denoiser=self._spec_hook(),
            valid_frames=vf,
        )

    def peaks_and_spectrograms(self, waveforms: torch.Tensor):
        """(B, T) waveforms on the device, taken as they are -> ((B,
        n_fft//2, frames) bool peak masks, (B, n_fft//2 + 1, frames)
        spectrograms as the peaks saw them). A spectrogram denoiser runs
        once: what it returned to the peaks is what comes back."""
        hook = self._spec_hook()
        seen = []

        def keep(sgram):
            seen.append(sgram if hook is None else hook(sgram))
            return seen[0]

        masks = find_peaks_batch(
            waveforms,
            density=self.density,
            n_fft=self.n_fft,
            n_hop=self.n_hop,
            f_sd=self.f_sd,
            maxpksperframe=self.maxpksperframe,
            denoiser=keep,
        )
        return masks, seen[0]

    def hashes_batch(
        self,
        waveforms: Waveform,
        shifts: Optional[int] = None,
        valid_samples: Optional[np.ndarray] = None,
    ) -> List[np.ndarray]:
        """(B, T) waveforms -> list of B (N_i, 2) unique sorted (time, hash)
        int32 arrays. Shift s drops ``int(s / shifts * n_hop)`` leading
        samples; all shifts are pruned as one stacked batch, and their union
        is ``landmarks.union_hashes`` with a budget that truncates nothing
        (one kernel launch on the card), read back once."""
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
            denoiser=self._spec_hook(),
        )
        budget = lm.MAXPAIRSPERPEAK * sum(
            lm.shift_max_peaks(int(m.shape[-1]), self.maxpksperframe)
            for m in masks_by_shift
        )
        times, hashes, n_valid = lm.union_hashes(
            masks_by_shift, self.maxpksperframe, budget
        )
        th = torch.stack([times, hashes], dim=-1).cpu().numpy()
        return [th[b, :n] for b, n in enumerate(n_valid.cpu().tolist())]

    # ------------------------------------------------------------ parity API

    def spreadpeaks(self, peaks, npoints=None, width: float = 4.0, base=None):
        """Max of Gaussian bumps at (index, value) peaks."""
        if base is None and npoints is not None:
            vec = np.zeros(npoints, dtype=np.float32)
        elif base is not None:
            npoints = len(base)
            vec = np.copy(base)
        else:
            raise ValueError("Please provide arguments npoints or base!")
        idx = np.arange(npoints)
        for pos, val in peaks:
            vec = np.maximum(vec, val * np.exp(-0.5 * ((idx - pos) / width) ** 2))
        return vec

    def spreadpeaksinvector(self, vector, width: float = 4.0):
        """:meth:`spreadpeaks` of the local maxima of ``vector``."""
        peaks = locmax(vector, indices=True)
        return self.spreadpeaks(
            [(p, v) for p, v in zip(peaks, vector[peaks])],
            npoints=len(vector), width=width,
        )

    def find_peaks(self, d: Waveform):
        """Single-waveform peak extraction: (pklist of (column, bin) in
        column-major order, (n_fft//2, frames) float32 peak mask,
        (n_fft//2 + 1, frames) spectrogram as the peaks saw it), numpy.
        The waveform is taken as it is: a waveform denoiser is applied by
        :meth:`wavfile2peaks`, :meth:`peaks_batch` and :meth:`hashes_batch`."""
        d = torch.as_tensor(d, dtype=torch.float32, device=self.device).reshape(-1)
        if d.shape[0] == 0:
            return [], np.array([]), np.array([])
        masks, spec = self.peaks_and_spectrograms(d[None, :])
        mask = masks[0].cpu().numpy()
        cols, bins = np.nonzero(mask.T)  # column-major order
        pklist = list(zip(cols.tolist(), bins.tolist()))
        return pklist, mask.astype(np.float32), spec[0].cpu().numpy()

    def wavfile2peaks(
        self,
        filename: Union[str, Waveform],
        shifts: Optional[int] = None,
        get_masks_waveforms: bool = False,
    ):
        """One file's (column, bin) peak list, or one list per shift with
        ``shifts`` >= 2. With ``get_masks_waveforms`` returns (peaks_mask,
        waveform, sgram) as numpy arrays, which the peaks-metrics harness
        reads."""
        d = self._as_batch(self._load(filename)[None, :])[0]
        self.soundfiledur = d.shape[0] / self.target_sr
        if get_masks_waveforms:
            _, mask, sgram = self.find_peaks(d)
            return mask, d.cpu().numpy(), sgram
        if shifts is None or shifts < 2:
            return self.find_peaks(d)[0]
        return [
            self.find_peaks(d[int(shift / self.shifts * self.n_hop) :])[0]
            for shift in range(shifts)
        ]

    def peaks2landmarks(self, pklist):
        """(column, bin) peaks -> (col, bin, bin2, dt) landmarks by the
        sequential pairing loop; the batched path packs hashes straight from
        the masks."""
        landmarks = []
        if len(pklist) > 0:
            scols = pklist[-1][0] + 1
            peaks_at: List[List[int]] = [[] for _ in range(scols)]
            for col, bin_ in pklist:
                peaks_at[col].append(bin_)
            for col in range(scols):
                for peak in peaks_at[col]:
                    pairsthispeak = 0
                    for col2 in range(col + self.mindt, min(scols, col + self.targetdt)):
                        if pairsthispeak >= self.maxpairsperpeak:
                            break
                        for peak2 in peaks_at[col2]:
                            if abs(peak2 - peak) < self.targetdf:
                                if pairsthispeak < self.maxpairsperpeak:
                                    landmarks.append((col, peak, peak2, col2 - col))
                                    pairsthispeak += 1
        return landmarks

    def wavfile2hashes(self, filename: Union[str, Waveform]) -> np.ndarray:
        """One file's unique sorted (time, hash) rows over ``self.shifts``
        shifts."""
        d = self._load(filename)
        self.soundfiledur = d.shape[0] / self.target_sr
        return self.hashes_batch(d[None, :], shifts=self.shifts)[0]

    def ingest(self, hashtable: HashTable, filename: str) -> Tuple[float, int]:
        """Store one file's hashes under its name; returns (duration in
        seconds, number of hashes)."""
        hashes = self.wavfile2hashes(filename)
        hashtable.store(filename, hashes)
        return self.soundfiledur, len(hashes)

    def _load(self, source: Union[str, Waveform]) -> Waveform:
        """One mono waveform at the analyzer's sample rate from an array or
        a tensor (kept on its device, taken to be at that rate already), a
        ``.npy`` file (likewise), a ``.pkl`` query (pickled at the query
        generator's rate) or a ``.wav`` or ``.mp3`` file (downmixed and
        resampled)."""
        if isinstance(source, torch.Tensor):
            return source.to(torch.float32).reshape(-1)
        if isinstance(source, np.ndarray):
            return source.astype(np.float32).reshape(-1)
        ext = str(source).rsplit(".", 1)[-1].lower()
        if ext == "npy":
            return np.load(source).astype(np.float32).reshape(-1)
        if ext == "pkl":
            with open(source, "rb") as f:
                d = np.asarray(pickle.load(f), np.float32).reshape(-1)
            return resample(d, WAVEFORM_SAMPLING_RATE, self.target_sr)
        if ext in ("wav", "mp3"):
            data, sr = read_wav(source)
            mono = data.mean(axis=0) if data.shape[0] > 1 else data[0]
            return resample(mono, sr, self.target_sr)
        raise ValueError(
            f"cannot decode {source!r}: only arrays, tensors and .npy, .pkl, "
            ".wav and .mp3 files"
        )

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
        with annotate("ingest.hash"):
            all_hashes = self.hashes_batch(
                waveforms, shifts=shifts, valid_samples=valid_samples
            )
        total = 0
        with annotate("ingest.store"):
            for name, hashes in zip(names, all_hashes):
                hashtable.store(name, hashes)
                total += len(hashes)
        return total


# the reference implementation's class name
Audfprint_peaks = AudfprintPeaks


def landmarks2hashes(landmarks_list):
    """(col, bin, bin2, dt) landmarks -> (time, 20-bit hash) int32 rows."""
    landmarks = np.array(landmarks_list)
    if landmarks.shape[0] == 0:
        return np.zeros((0, 2), dtype=np.int32)
    hashes = np.zeros((landmarks.shape[0], 2), dtype=np.int32)
    hashes[:, 0] = landmarks[:, 0]
    hashes[:, 1] = (
        ((landmarks[:, 1] & 255) << 12)
        | (((landmarks[:, 2] - landmarks[:, 1]) & 63) << 6)
        | (landmarks[:, 3] & 63)
    )
    return hashes

"""Host-side audio IO (the port's own copy of
musicfpaugment_tpu/data/audio_io.py).

``.mp3`` paths decode through the native libmpg123 decoder
(``data/native.py``, built by g++ on first use from ``native/*.cc``); WAV
goes through scipy, which gives the native WAV decoder's samples bit for
bit (``tests/test_torch_native_io.py``). Resampling is scipy's polyphase
resampler. This is the host boundary: everything after it is
device-resident.

``Audio``: offset/num_samples windowing expressed in *target*-rate samples,
mono downmix, resample, off-by-one pad/trim repair.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import List, Sequence, Tuple, Union

import numpy as np

SUPPORTED_EXTENSIONS = (".wav", ".mp3")


def _is_mp3(path) -> bool:
    return str(path).lower().endswith(".mp3")


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Return (samples (channels, time) float32 in [-1, 1], sample_rate).

    Dispatches on the extension: ``.mp3`` through the native libmpg123
    decoder (raises if it cannot be built or loaded), anything else as a
    RIFF/WAVE file."""
    if _is_mp3(path):
        raise ValueError("the reference reads no mp3")
    import scipy.io.wavfile

    sr, data = scipy.io.wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T
    return np.ascontiguousarray(data), int(sr)


def wav_metadata(path: Union[str, Path]) -> Tuple[int, int]:
    """Return (num_samples, sample_rate) without decoding the payload
    (an mp3 by a stream scan)."""
    if _is_mp3(path):
        raise ValueError("the reference reads no mp3")
    import wave

    try:
        with wave.open(str(path), "rb") as f:
            return f.getnframes(), f.getframerate()
    except wave.Error:  # a float WAV: scipy maps it without decoding
        import scipy.io.wavfile

        sr, data = scipy.io.wavfile.read(str(path), mmap=True)
        return int(data.shape[0]), int(sr)


def resample(samples: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample on the trailing axis."""
    if orig_sr == target_sr:
        return samples
    import scipy.signal

    g = math.gcd(orig_sr, target_sr)
    return scipy.signal.resample_poly(
        samples, target_sr // g, orig_sr // g, axis=-1
    ).astype(np.float32)


def find_audio_files_in_paths(
    paths: Sequence[Union[str, Path]],
    filename_endings: Tuple[str, ...] = SUPPORTED_EXTENSIONS,
    traverse_subdirectories: bool = True,
    follow_symlinks: bool = True,
) -> List[str]:
    """Audio files named by, or found under, ``paths``."""
    file_paths: List[str] = []
    for p in paths:
        sp = str(p)
        if sp.lower().endswith(filename_endings):
            file_paths.append(os.path.abspath(sp))
        elif os.path.isdir(sp):
            for root, _, filenames in os.walk(sp, followlinks=follow_symlinks):
                for filename in sorted(filenames):
                    if filename.lower().endswith(filename_endings):
                        file_paths.append(
                            os.path.join(os.path.abspath(root), filename)
                        )
                if not traverse_subdirectories:
                    break
    return file_paths


class Audio:
    """Audio IO with on-the-fly resampling (numpy arrays).

    ``sample_offset`` / ``num_samples`` are expressed at the *target* rate.
    """

    def __init__(self, sample_rate: int, mono: bool = True):
        self.sample_rate = sample_rate
        self.mono = mono

    def get_num_samples(self, file) -> int:
        if isinstance(file, dict):
            if "samples" in file:
                num_samples = np.asarray(file["samples"]).shape[1]
                sr = int(file["sample_rate"])
            else:
                num_samples, sr = wav_metadata(file["audio"])
        else:
            num_samples, sr = wav_metadata(file)
        return math.floor(num_samples * self.sample_rate / sr)

    def rms_normalize(self, samples: np.ndarray) -> np.ndarray:
        rms = np.sqrt(np.mean(np.square(samples), axis=-1, keepdims=True))
        return samples / (rms + 1e-8)

    def downmix_and_resample(self, samples: np.ndarray, sr: int) -> np.ndarray:
        if self.mono and samples.shape[0] > 1:
            samples = samples.mean(axis=0, keepdims=True)
        return resample(samples, sr, self.sample_rate)

    def __call__(
        self,
        file,
        sample_offset: int = 0,
        num_samples: int | None = None,
    ) -> np.ndarray:
        if isinstance(file, dict):
            # {"samples": (channels, time) array, "sample_rate": int}
            if "samples" in file:
                data = np.asarray(file["samples"], np.float32)
                orig_sr = int(file["sample_rate"])
            else:
                data, orig_sr = read_wav(file["audio"])
            channel = file.get("channel")
            if channel is not None:
                data = data[channel - 1 : channel, :]
        else:
            data, orig_sr = read_wav(file)
        orig_off = round(sample_offset * orig_sr / self.sample_rate)
        if num_samples is None:
            orig_n = data.shape[-1] - orig_off
        else:
            orig_n = round(num_samples * orig_sr / self.sample_rate)
        if orig_off + orig_n > data.shape[-1]:
            raise ValueError(
                f"Sample offset {orig_off} -- number of samples {orig_n} -- "
                f"total number of samples {data.shape[-1]}."
            )
        result = self.downmix_and_resample(data[:, orig_off : orig_off + orig_n], orig_sr)
        if num_samples is not None:
            if result.shape[-1] > num_samples:
                result = result[:, :num_samples]
            elif result.shape[-1] < num_samples:
                result = np.pad(
                    result, ((0, 0), (0, num_samples - result.shape[-1]))
                )
        return result

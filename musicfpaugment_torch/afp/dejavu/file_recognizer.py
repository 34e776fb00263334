"""Query recognition with per-stage timing (port of
musicfpaugment_tpu/afp/dejavu/file_recognizer.py)."""

from __future__ import annotations

import abc
from time import time
from typing import Any, Dict, List, Tuple

import numpy as np

from musicfpaugment_torch.afp.dejavu.dejavu import read
from musicfpaugment_torch.afp.dejavu.variables import MIN_HASHES


class BaseRecognizer(object, metaclass=abc.ABCMeta):
    def __init__(self, dejavu):
        self.dejavu = dejavu
        self.Fs = dejavu.settings["samplerate"]

    def _recognize(self, *data) -> Tuple[List[Dict[str, Any]], float, float, float]:
        fingerprint_times = []
        hashes = set()
        for channel in data:
            fingerprints, fingerprint_time = self.dejavu.generate_fingerprints(channel)
            fingerprint_times.append(fingerprint_time)
            hashes |= set(fingerprints)
        matches, dedup_hashes, query_time = self.dejavu.find_matches(hashes)
        t = time()
        final_results = self.dejavu.align_matches(matches, dedup_hashes, len(hashes))
        align_time = time() - t
        return final_results, float(np.sum(fingerprint_times)), query_time, align_time

    @abc.abstractmethod
    def recognize(self) -> Dict[str, Any]:
        pass


class FileRecognizer(BaseRecognizer):
    def recognize_file(self, filename) -> Dict[str, Any]:
        """The top match of one file or array, its timings, and ``match``:
        the top song's aligned count above ``MIN_HASHES``."""
        channels, self.Fs, _ = read(
            filename,
            denoising=self.dejavu.denoising,
            denoising_model=self.dejavu.denoising_model or "unet",
            wave_denoiser=self.dejavu.wave_denoiser,
            sample_rate=self.dejavu.settings["samplerate"],
            device=self.dejavu.device,
        )
        t = time()
        matches, fingerprint_time, query_time, align_time = self._recognize(*channels)
        t = time() - t
        if len(matches):
            is_match = matches[0]["nb_matches_with_offset"] > MIN_HASHES
        else:
            is_match = False
        return {
            "total_time": t,
            "fingerprint_time": fingerprint_time,
            "query_time": query_time,
            "align_time": align_time,
            "results": matches,
            "match": is_match,
        }

    def recognize(self, filename) -> Dict[str, Any]:
        return self.recognize_file(filename)

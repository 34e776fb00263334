"""audfprint-style landmark fingerprinting, PyTorch/CUDA."""

from musicfpaugment_torch.afp.audfprint.analyzer import (
    Audfprint_peaks,
    AudfprintPeaks,
    landmarks2hashes,
)
from musicfpaugment_torch.afp.audfprint.hash_table import HashTable
from musicfpaugment_torch.afp.audfprint.matcher import Matcher
from musicfpaugment_torch.afp.audfprint.matcher_device import DeviceMatcher
from musicfpaugment_torch.afp.audfprint.peaks import find_peaks_batch

__all__ = [
    "AudfprintPeaks",
    "Audfprint_peaks",
    "landmarks2hashes",
    "HashTable",
    "Matcher",
    "DeviceMatcher",
    "find_peaks_batch",
]

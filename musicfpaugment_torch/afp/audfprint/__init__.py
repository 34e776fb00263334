"""audfprint-style landmark fingerprinting, PyTorch/CUDA."""

from musicfpaugment_torch.afp.audfprint.analyzer import AudfprintPeaks
from musicfpaugment_torch.afp.audfprint.hash_table import HashTable
from musicfpaugment_torch.afp.audfprint.matcher_device import DeviceMatcher
from musicfpaugment_torch.afp.audfprint.peaks import find_peaks_batch

__all__ = ["AudfprintPeaks", "HashTable", "DeviceMatcher", "find_peaks_batch"]

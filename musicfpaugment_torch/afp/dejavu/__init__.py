"""Dejavu-style fingerprinting, PyTorch/CUDA: device peak detection, SQL
store, and the batched device matcher."""

from musicfpaugment_torch.afp.dejavu.dejavu import Dejavu, read, unique_hash
from musicfpaugment_torch.afp.dejavu.file_recognizer import (
    BaseRecognizer,
    FileRecognizer,
)
from musicfpaugment_torch.afp.dejavu.fingerprint import (
    detect_peaks_mask,
    fingerprint,
    fingerprint_spectrogram_batch,
    generate_hashes,
    pack_hashes,
    pack_hashes_from_masks,
)
from musicfpaugment_torch.afp.dejavu.matcher_device import (
    DejavuDeviceIndex,
    DejavuDeviceMatcher,
)
from musicfpaugment_torch.afp.dejavu.sqlite_database import SQLiteDatabase

__all__ = [
    "Dejavu",
    "read",
    "unique_hash",
    "BaseRecognizer",
    "FileRecognizer",
    "detect_peaks_mask",
    "fingerprint",
    "fingerprint_spectrogram_batch",
    "generate_hashes",
    "pack_hashes",
    "pack_hashes_from_masks",
    "DejavuDeviceIndex",
    "DejavuDeviceMatcher",
    "SQLiteDatabase",
]

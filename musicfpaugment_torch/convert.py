"""Carry state across from the JAX package.

The ported slices have no model weights; what a JAX run leaves behind is its
:class:`HashTable` and its augmentation banks. :func:`hash_table_from_arrays`
adopts that table's numpy arrays (the fields of its npz file), and
:func:`noise_bank_from_arrays` / :func:`ir_bank_from_arrays` the fields of a
JAX ``NoiseBank`` / ``IRBank`` as numpy arrays, all without importing the
JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint.hash_table import HashTable
from musicfpaugment_torch.augment.banks import IRBank, NoiseBank
from musicfpaugment_torch.device import DeviceLike, resolve_device


def hash_table_from_arrays(
    table: np.ndarray,
    counts: np.ndarray,
    names: Sequence,
    hashesperid: np.ndarray,
    meta: Sequence[int],
) -> HashTable:
    """A port :class:`HashTable` holding copies of a JAX-side table's arrays.
    ``meta`` is [hashbits, depth, maxtimebits, ht_version]; ``None`` or ""
    names mark freed ids."""
    hashbits, depth = int(meta[0]), int(meta[1])
    table = np.array(table, np.uint32)
    if table.shape != (1 << hashbits, depth):
        raise ValueError(f"table shape {table.shape} != (2^{hashbits}, {depth})")
    ht = HashTable.__new__(HashTable)
    ht._rng = np.random.default_rng(0)
    ht.set_arrays(
        table,
        np.array(counts, np.int32),
        ["" if n is None else n for n in names],
        np.array(hashesperid),
        meta,
    )
    return ht


def _tensor(array, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(array, dtype)).to(device)


def noise_bank_from_arrays(
    clips: np.ndarray,
    scene_starts: np.ndarray,
    scene_counts: np.ndarray,
    sample_rate: int,
    device: DeviceLike = None,
) -> NoiseBank:
    """A port :class:`NoiseBank` on ``device`` (``None`` = CUDA) holding
    copies of a JAX-side bank's fields."""
    device = resolve_device(device)
    clips = _tensor(clips, np.float32, device)
    starts = _tensor(scene_starts, np.int32, device)
    counts = _tensor(scene_counts, np.int32, device)
    if clips.ndim != 2 or starts.shape != counts.shape or starts.ndim != 1:
        raise ValueError("clips must be (N, L) and scene_starts, scene_counts (S,)")
    if int(counts.sum()) != clips.shape[0]:
        raise ValueError(f"scene_counts sum to {int(counts.sum())}, not {clips.shape[0]} rows")
    return NoiseBank(clips, starts, counts, int(sample_rate))


def ir_bank_from_arrays(
    irs: np.ndarray, lengths: np.ndarray, sample_rate: int, device: DeviceLike = None
) -> IRBank:
    """A port :class:`IRBank` on ``device`` (``None`` = CUDA) holding copies
    of a JAX-side bank's fields."""
    device = resolve_device(device)
    irs = _tensor(irs, np.float32, device)
    lengths = _tensor(lengths, np.int32, device)
    if irs.ndim != 2 or lengths.shape != (irs.shape[0],):
        raise ValueError("irs must be (N, L) and lengths (N,)")
    return IRBank(irs, lengths, int(sample_rate))

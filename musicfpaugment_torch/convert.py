"""Carry state across from the JAX package.

The audfprint slice has no model weights; what a JAX run leaves behind is
its :class:`HashTable`. :func:`hash_table_from_arrays` adopts that table's
numpy arrays (the fields of its npz file) without importing the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from musicfpaugment_torch.afp.audfprint.hash_table import HashTable


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

"""Fixed-array fingerprint hash table, host side (numpy copy of
musicfpaugment_tpu/afp/audfprint/hash_table.py).

2^20 buckets x depth 100 of uint32 values ``(id + 1) << maxtimebits | time``,
attempted-insert counts per bucket, reservoir sampling on overflow with the
same ``default_rng(0)`` stream, and the same npz format, so a table written
by either package loads in the other. The device copy the matcher gathers
from is built by ``DeviceMatcher.refresh``; ``get_hits`` is the host lookup
that the numpy ``Matcher`` oracle reads.
"""

from __future__ import annotations

import math
import os
from typing import Any, List, Optional, Union

import numpy as np

HT_VERSION = 20250816


def _bitsfor(maxval: int) -> int:
    """Bits for a power-of-two maxval."""
    maxvalbits = int(round(math.log(maxval) / math.log(2)))
    if maxval != (1 << maxvalbits):
        raise ValueError("maxval must be a power of 2, not %d" % maxval)
    return maxvalbits


class HashTable:
    def __init__(
        self,
        filename: Optional[str] = None,
        hashbits: int = 20,
        depth: int = 100,
        maxtime: int = 16384,
        rng: Optional[np.random.Generator] = None,
    ):
        self._rng = rng or np.random.default_rng(0)
        if filename is not None:
            self.load(filename)
            return
        self.hashbits = hashbits
        self.depth = depth
        self.maxtimebits = _bitsfor(maxtime)
        size = 2**self.hashbits
        self.table = np.zeros((size, self.depth), dtype=np.uint32)
        self.counts = np.zeros(size, dtype=np.int32)
        self.names: List[Any] = []
        self.hashesperid = np.zeros(0, np.uint32)
        self.ht_version = HT_VERSION
        self._name_idx: Optional[dict] = None
        self._free_ids: List[int] = []

    def _name_index(self) -> dict:
        """name -> id dict, built lazily and kept in sync by ``name_to_id``."""
        if self._name_idx is None:
            self._name_idx = {n: i for i, n in enumerate(self.names) if n is not None}
        return self._name_idx

    def name_to_id(self, name: Union[int, str], add_if_missing: bool = False) -> int:
        if isinstance(name, (str, bytes)):
            idx = self._name_index()
            got = idx.get(name)
            if got is not None:
                return got
            if not add_if_missing:
                raise ValueError("name " + str(name) + " not found")
            if self._free_ids:  # an id that ``remove`` freed
                id_ = self._free_ids.pop()
                self.names[id_] = name
                self.hashesperid[id_] = 0
            else:
                id_ = len(self.names)
                self.names.append(name)
                self.hashesperid = np.append(self.hashesperid, [0])
            idx[name] = id_
            return id_
        if not isinstance(name, (int, np.integer)):
            raise TypeError(f"name must be str or int, got {type(name)}")
        return int(name)

    def store(self, name: Union[int, str], timehashpairs: np.ndarray) -> None:
        """Insert (time, hash) rows under ``name``: a vectorized form of the
        sequential insert loop, entries taken in submission order (stable
        sort), overflowing buckets reservoir-sampled."""
        id_ = self.name_to_id(name, add_if_missing=True)
        pairs = np.asarray(timehashpairs)
        if pairs.size == 0:
            return
        hashmask = (1 << self.hashbits) - 1
        timemask = (1 << self.maxtimebits) - 1
        idval = np.uint32((id_ + 1) << self.maxtimebits)

        h = pairs[:, 1].astype(np.int64) & hashmask
        t = pairs[:, 0].astype(np.int64) & timemask
        vals = (idval + t).astype(np.uint32)

        order = np.argsort(h, kind="stable")
        hs, vs = h[order], vals[order]
        # position within each equal-hash run
        run_start = np.concatenate([[True], hs[1:] != hs[:-1]])
        run_ids = np.cumsum(run_start) - 1
        first_pos = np.nonzero(run_start)[0]
        within = np.arange(len(hs)) - first_pos[run_ids]
        eff_count = self.counts[hs] + within  # count at insertion time

        slot = eff_count.copy()
        over = eff_count >= self.depth
        if over.any():
            # reservoir: uniform slot in [0, eff_count]; keep if < depth
            rand_slots = (
                self._rng.random(over.sum()) * (eff_count[over] + 1)
            ).astype(np.int64)
            slot[over] = rand_slots
        keep = slot < self.depth
        self.table[hs[keep], slot[keep]] = vs[keep]
        np.add.at(self.counts, hs, 1)
        self.hashesperid[id_] += len(pairs)

    # --------------------------------------------------------------- query

    def get_entry(self, hash_: int) -> np.ndarray:
        """[id, time] rows stored under one hash."""
        vals = self.table[hash_, : min(self.depth, self.counts[hash_])]
        maxtimemask = (1 << self.maxtimebits) - 1
        ids = (vals >> self.maxtimebits).astype(np.int64) - 1
        return np.stack([ids, vals & maxtimemask], axis=1).astype(np.int32)

    def get_hits_dense(self, hashes: np.ndarray):
        """Dense (Q, depth) gather for (time, hash) queries: (ids, dts,
        valid_mask), dts = stored time - query time."""
        hashmask = (1 << self.hashbits) - 1
        maxtimemask = (1 << self.maxtimebits) - 1
        qt = hashes[:, 0].astype(np.int64)
        qh = hashes[:, 1].astype(np.int64) & hashmask
        nids = np.minimum(self.depth, self.counts[qh])
        tabvals = self.table[qh]
        valid = np.arange(self.depth)[None, :] < nids[:, None]
        ids = (tabvals >> self.maxtimebits).astype(np.int32) - 1
        dts = ((tabvals & maxtimemask).astype(np.int64) - qt[:, None]).astype(np.int32)
        return ids, dts, valid

    def get_hits(self, hashes: np.ndarray) -> np.ndarray:
        """[id, delta_time, hash, time] int32 rows for (time, hash) queries,
        query by query, each bucket in slot order."""
        hashes = np.asarray(hashes)
        if hashes.size == 0:
            return np.zeros((0, 4), np.int32)
        ids, dts, valid = self.get_hits_dense(hashes)
        qh = hashes[:, 1].astype(np.int64) & ((1 << self.hashbits) - 1)
        out = np.stack(
            [
                ids,
                dts,
                np.broadcast_to(qh[:, None], ids.shape),
                np.broadcast_to(hashes[:, 0].astype(np.int64)[:, None], ids.shape),
            ],
            axis=-1,
        )
        return out[valid].astype(np.int32)

    # --------------------------------------------------------------- admin

    def totalhashes(self) -> int:
        return int(np.sum(self.counts))

    def reset(self) -> None:
        """Empty the table and forget every name."""
        self.table[:, :] = 0
        self.counts[:] = 0
        self.names = []
        self.hashesperid = np.zeros(0, np.uint32)
        self._name_idx = None
        self._free_ids = []

    def remove(self, name: Union[str, int]) -> None:
        """Remove every entry of one id; the id is freed for the next new
        name."""
        id_ = self.name_to_id(name)
        id_in_table = (self.table >> self.maxtimebits) == id_ + 1
        for hash_ in np.nonzero(np.max(id_in_table, axis=1))[0]:
            n = min(self.depth, self.counts[hash_])
            kept = self.table[hash_, :n][~id_in_table[hash_, :n]]
            self.table[hash_] = np.concatenate(
                [kept, np.zeros(self.depth - len(kept), np.uint32)]
            )
            self.counts[hash_] = len(kept)
        self.names[id_] = None
        self.hashesperid[id_] = 0
        self._name_idx = None
        self._free_ids.append(id_)

    def retrieve(self, name: Union[str, int]) -> np.ndarray:
        """All (time, hash) int32 rows stored for one id, by hash."""
        id_ = self.name_to_id(name)
        maxtimemask = (1 << self.maxtimebits) - 1
        n = np.minimum(self.depth, self.counts)[:, None]
        valid = np.arange(self.depth)[None, :] < n
        match = valid & ((self.table >> self.maxtimebits) == id_ + 1)
        hash_idx, slot_idx = np.nonzero(match)
        times = self.table[hash_idx, slot_idx] & maxtimemask
        return np.stack([times, hash_idx], axis=1).astype(np.int32)

    def list(self, print_fn=None) -> None:
        """Print "name (n hashes)" for every name in the table."""
        print_fn = print_fn or print
        for name, count in zip(self.names, self.hashesperid):
            if name:
                print_fn(str(name) + " (" + str(int(count)) + " hashes)")

    def save(self, name: str) -> None:
        """Atomic compressed npz write (the JAX package's format)."""
        path = name if name.endswith(".npz") else name + ".npz"
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp,
            table=self.table,
            counts=self.counts,
            names=np.asarray(
                ["" if n is None else str(n) for n in self.names], dtype=object
            ),
            hashesperid=self.hashesperid,
            meta=np.asarray(
                [self.hashbits, self.depth, self.maxtimebits, self.ht_version]
            ),
        )
        os.replace(tmp, path)

    def load(self, name: str) -> None:
        path = name if os.path.exists(name) else name + ".npz"
        with np.load(path, allow_pickle=True) as z:
            self.set_arrays(
                z["table"], z["counts"], z["names"].tolist(), z["hashesperid"], z["meta"]
            )

    def set_arrays(self, table, counts, names, hashesperid, meta) -> None:
        """Adopt a table's arrays as the npz format holds them (``meta`` =
        [hashbits, depth, maxtimebits, ht_version]; empty names are freed
        ids)."""
        self.table = np.asarray(table, np.uint32)
        self.counts = np.asarray(counts, np.int32)
        self.names = [n if n != "" else None for n in names]
        self.hashesperid = np.asarray(hashesperid)
        self.hashbits, self.depth, self.maxtimebits, self.ht_version = (
            int(m) for m in meta
        )
        self._name_idx = None
        self._free_ids = [i for i, n in enumerate(self.names) if n is None]

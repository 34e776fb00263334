"""Batched device-side Dejavu matching (port of
musicfpaugment_tpu/afp/dejavu/matcher_device.py).

The corpus is a CSR index over the injective 26-bit packed key ``(f1 << 17)
| (f2 << 8) | dt`` (a bijection of the triple the truncated SHA1 encodes, so
match sets equal the SQL path's): ``starts`` (nbuckets + 1,) int32 and
``rows`` packing ``(song_id << timebits) | offset``, kept as int64 on the
card (torch's uint32 has no shifts on CUDA, and int32 overflows once song
ids reach 2^17). A batch of queries goes waveform -> verdict in two stages:
fingerprinting and hash packing, one scalar readback of the widest used hash
lane, then the match on the hash lanes sliced to the smallest power-of-two
tier covering it. The match gathers each hash's rows, packs every hit into
one cell key ``sid * T3 + (dt + mqf) + 1``, sorts once and takes run
lengths; the verdict is the first-wins argmax over the cells in (sid, dt)
order, which is the tie-breaking of :meth:`Dejavu.align_matches` (count,
then the lower song id, then the lower offset). ``dedup_hashes`` (one count
per fetched DB row) is the sum of a first-of-key flag over the winning
song's hits. Outputs are bit-identical to the JAX ``_dejavu_match_impl``
(tests/test_torch_dejavu_matcher.py).

``max_rows_per_hash`` keeps the ``max_rows_per_hash`` smallest (song_id,
offset) rows of a hot key (the SQL path fetches them all); ``finalize()``
reports how many rows it dropped. The index's npz format is the JAX
package's, so an index saved by either package loads in the other.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint.matcher_device import _run_length
from musicfpaugment_torch.afp.dejavu.fingerprint import (
    DEFAULT_SETTINGS,
    INVALID_KEY,
    fingerprint_spectrogram_batch,
    pack_hashes_from_masks,
)
from musicfpaugment_torch.afp.dejavu.variables import (
    FINGERPRINTED_CONFIDENCE,
    FINGERPRINTED_HASHES,
    HASHES_MATCHED,
    INPUT_CONFIDENCE,
    INPUT_CONFIDENCE_2,
    INPUT_HASHES,
    MIN_HASHES,
    OFFSET,
    OFFSET_SECS,
    SONG_ID,
    SONG_NAME,
)
from musicfpaugment_torch.device import DeviceLike, resolve_device
from musicfpaugment_torch.parallel.mesh import canonical_device, distinct, make_mesh, shard_bounds


def _pow2ceil(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, n)))))


def _n_frames(n_samples: int, st: Dict[str, Any]) -> int:
    return max(1, 1 + (n_samples - st["n_fft"]) // st["n_hop"])


def _settings(settings: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    st = dict(DEFAULT_SETTINGS)
    st.update(settings or {})
    return st


def _warn_overflow(n_over: int, n: int, max_peaks: int, what: str) -> None:
    if n_over:
        warnings.warn(
            f"{n_over}/{n} {what} exceeded the {max_peaks}-peak budget "
            "(truncated earliest-first); pass a larger max_peaks",
            stacklevel=3,
        )


def fingerprint_and_pack(
    wavs: torch.Tensor,
    st: Dict[str, Any],
    max_peaks: int,
    denoiser: Optional[Callable] = None,
):
    """(B, T) waveforms -> :func:`pack_hashes_from_masks` of their peak
    masks at the settings ``st``, on the waveforms' device."""
    _, masks, _ = fingerprint_spectrogram_batch(
        wavs, float(st["samplerate"]), int(st["n_fft"]), int(st["n_hop"]),
        float(st["amp_min"]), denoiser=denoiser,
    )
    return pack_hashes_from_masks(masks, max_peaks, int(st["fan_value"]))


class DejavuDeviceIndex:
    """Host-built, device-matchable fingerprint corpus.

    Songs are added as packed (key, t1) hash lists (:func:`pack_hashes`'s
    output) or as waveform batches fingerprinted on the device
    (:meth:`ingest_arrays`); ``finalize()`` freezes the corpus into the CSR
    arrays the matcher puts on the card. ``timebits`` bounds stored offsets
    (2^14 frames: ~8.7 min at hop 256 and 8 kHz); song ids take the other
    32 - timebits bits."""

    def __init__(self, timebits: int = 14, max_rows_per_hash: int = 256) -> None:
        self.timebits = timebits
        self.max_rows_per_hash = max_rows_per_hash
        self.names: List[str] = []
        self.total_hashes: List[int] = []
        self._keys: List[np.ndarray] = []
        self._offs: List[np.ndarray] = []
        self._frozen: Optional[Tuple[np.ndarray, np.ndarray, int, int]] = None
        self.rows_dropped = 0

    # ------------------------------------------------------------ build

    def add_song(self, name: str, packed_hashes: Sequence[Tuple[int, int]]) -> int:
        """Add one song's (key, t1) list, deduplicated here (the SQL path
        stores ``set(hashes)``). Returns its song id."""
        arr = np.asarray(list(packed_hashes), np.int64).reshape(-1, 2)
        arr = np.unique(arr, axis=0)
        if arr.size and int(arr[:, 1].max()) >= (1 << self.timebits):
            raise ValueError(
                f"stored offset {int(arr[:, 1].max())} exceeds "
                f"2^{self.timebits}; raise timebits"
            )
        sid = len(self.names)
        if sid >= (1 << (32 - self.timebits)):
            raise ValueError("song id space exhausted; lower timebits")
        self.names.append(name)
        self.total_hashes.append(int(arr.shape[0]))
        self._keys.append(arr[:, 0].astype(np.int32))
        self._offs.append(arr[:, 1].astype(np.int32))
        self._frozen = None
        return sid

    def ingest_arrays(
        self,
        names: Sequence[str],
        waveforms,
        settings: Optional[Dict[str, Any]] = None,
        max_peaks: Optional[int] = None,
        device: DeviceLike = None,
    ) -> None:
        """Fingerprint a (B, T) waveform batch on ``device`` and add each row
        as a song (:meth:`Dejavu.fingerprint_arrays` with the hashing on the
        device, and no x 32767: the per-example max normalisation makes the
        scale invisible up to rounding). Only the valid hashes come back to
        the host."""
        st = _settings(settings)
        wavs = torch.as_tensor(waveforms, dtype=torch.float32, device=resolve_device(device))
        B, T = wavs.shape
        names = [str(n) for n in names]
        if len(names) != B:
            raise ValueError(f"got {len(names)} names for {B} waveform rows")
        mp = max_peaks or _pow2ceil(4 * _n_frames(T, st))
        keys, t1, valid, _kf, n_distinct, n_over = fingerprint_and_pack(wavs, st, mp)
        n_distinct = n_distinct.cpu().numpy()
        keys = keys[valid].cpu().numpy()
        offs = t1[valid].cpu().numpy()
        _warn_overflow(int(n_over), B, mp, "tracks")
        # validate the whole batch before adding any of it
        if len(self.names) + B > (1 << (32 - self.timebits)):
            raise ValueError("song id space exhausted; lower timebits")
        if offs.size and int(offs.max()) >= (1 << self.timebits):
            raise ValueError("stored offset exceeds timebits range")
        splits = np.cumsum(n_distinct)[:-1]
        self.names += names
        self.total_hashes += [int(n) for n in n_distinct]
        self._keys += np.split(keys, splits)
        self._offs += np.split(offs, splits)
        self._frozen = None

    def finalize(self) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Freeze into (starts, rows, nbuckets, depth): rows sorted by (key,
        song_id, offset) as uint32, each key cut to its first
        ``max_rows_per_hash`` rows, the int32 CSR prefix over a power-of-two
        key space sized to the largest stored key."""
        if self._frozen is not None:
            return self._frozen
        if self._keys:
            keys = np.concatenate(self._keys).astype(np.int64)
            offs = np.concatenate(self._offs).astype(np.int64)
            sids = np.repeat(np.arange(len(self._keys), dtype=np.int64), [k.size for k in self._keys])
        else:
            keys = offs = sids = np.zeros(0, np.int64)
        # one sort by (key, song id, offset): the row word (song id above
        # the offset's timebits) fits 32 bits and keys are non-negative, so
        # the three pack into one int64 in that order: one sort of words
        # where a lexsort makes three passes and three gathers
        packed = np.sort((keys << 32) | (sids << self.timebits) | offs)
        keys, words = packed >> 32, packed & 0xFFFFFFFF
        if keys.size:
            # rank within each key's run -> cap hot keys
            first = np.concatenate([[True], keys[1:] != keys[:-1]])
            run_start = np.maximum.accumulate(np.where(first, np.arange(keys.size), 0))
            rank = np.arange(keys.size) - run_start
            keep = rank < self.max_rows_per_hash
            self.rows_dropped = int((~keep).sum())
            keys, words = keys[keep], words[keep]
            depth = int(rank[keep].max()) + 1 if keys.size else 1
            nbuckets = _pow2ceil(int(keys.max()) + 2)
        else:
            depth = 1
            nbuckets = 2
        counts = np.bincount(keys, minlength=nbuckets).astype(np.int64)
        starts = np.zeros(nbuckets + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        if starts[-1] >= 2**31:
            raise ValueError("corpus exceeds int32 row space")
        rows = words.astype(np.uint32)
        self._frozen = (starts.astype(np.int32), rows, nbuckets, depth)
        return self._frozen

    # ------------------------------------------------------------ io

    def save(self, path: str) -> None:
        """Atomic save of the raw (pre-CSR) hash lists, in the JAX package's
        npz format; a torn write leaves the previous file as it was."""
        keys = np.concatenate(self._keys) if self._keys else np.zeros(0, np.int32)
        offs = np.concatenate(self._offs) if self._offs else np.zeros(0, np.int32)
        counts = np.asarray([k.size for k in self._keys], np.int64)
        tmp = str(path) + ".tmp.npz"
        np.savez(
            tmp[:-4],
            keys=keys,
            offs=offs,
            song_counts=counts,
            timebits=np.int64(self.timebits),
            max_rows_per_hash=np.int64(self.max_rows_per_hash),
            names=np.asarray(self.names, object),
            total_hashes=np.asarray(self.total_hashes, np.int64),
        )
        os.replace(tmp, str(path))

    @classmethod
    def load(cls, path: str) -> "DejavuDeviceIndex":
        with np.load(path, allow_pickle=True) as z:
            idx = cls(
                timebits=int(z["timebits"]),
                max_rows_per_hash=int(z["max_rows_per_hash"]),
            )
            idx.names = [str(n) for n in z["names"]]
            idx.total_hashes = [int(n) for n in z["total_hashes"]]
            splits = np.cumsum(z["song_counts"])[:-1]
            idx._keys = [a.astype(np.int32) for a in np.split(z["keys"], splits)]
            idx._offs = [a.astype(np.int32) for a in np.split(z["offs"], splits)]
        return idx


def _dejavu_match_impl(
    starts: torch.Tensor,
    rows: torch.Tensor,
    keys: torch.Tensor,
    t1: torch.Tensor,
    valid: torch.Tensor,
    key_first: torch.Tensor,
    *,
    depth: int,
    num_ids: int,
    timebits: int,
    mqf: int,
    max_store_time: int,
    nbuckets: int,
):
    """keys/t1/valid/key_first: (B, H) sorted deduplicated query hashes
    (:func:`pack_hashes_from_masks`' layout); ``starts`` int32 and ``rows``
    int64 the CSR corpus on the same device. Returns per query int32
    (best_sid, best_count, best_offset, dedup_best); best_sid == -1 when no
    row matched."""
    B, H = keys.shape
    dev = keys.device
    D = depth
    T = max_store_time + mqf
    T3 = T + 3
    K = H * D

    ok_key = valid & (keys >= 0) & (keys < nbuckets)
    k = torch.clamp(keys, 0, nbuckets - 1).long()
    s0 = starts[k]  # (B, H)
    cnt = torch.clamp(starts[k + 1] - s0, max=D)
    slot = torch.arange(D, dtype=torch.int32, device=dev)[None, None, :]
    ridx = torch.clamp(s0[..., None] + slot, 0, max(int(rows.shape[0]) - 1, 0))
    r = rows[ridx.long()]  # (B, H, D): each hash's contiguous rows
    hit_ok = (slot < cnt[..., None]) & ok_key[..., None]
    sid = (r >> timebits).to(torch.int32)
    off = (r & ((1 << timebits) - 1)).to(torch.int32)
    dt = torch.clamp(off - t1[..., None] + mqf, 0, T)

    key_dtype = torch.int32 if (num_ids + 1) * T3 < 2**31 else torch.int64
    sentinel = num_ids * T3
    cell = torch.where(
        hit_ok, sid.to(key_dtype) * T3 + (dt + 1).to(key_dtype), sentinel
    ).reshape(B, K)
    isf = (hit_ok & key_first[..., None]).reshape(B, K)
    s = torch.sort(cell, dim=-1).values

    start, length = _run_length(s)
    count_at = torch.where(start & (s < sentinel), length, 0)
    # first-wins argmax over ascending (sid, dt) cells: count desc, then sid
    # asc, then offset asc, as align_matches breaks ties
    best_pos = torch.argmax(count_at, dim=-1, keepdim=True)
    best_count = torch.gather(count_at, 1, best_pos)[:, 0]
    bk = torch.gather(s, 1, best_pos)[:, 0]
    best_sid = torch.div(bk, T3, rounding_mode="floor").to(torch.int32)
    best_dt = (bk - best_sid.to(key_dtype) * T3).to(torch.int32) - 1 - mqf
    # the winning song's first-of-key hits; a sum, so the unsorted cells do
    in_best = (cell < sentinel) & (torch.div(cell, T3, rounding_mode="floor") == best_sid[:, None])
    dedup_best = (isf & in_best).sum(dim=-1, dtype=torch.int32)
    matched = best_count > 0
    return (
        torch.where(matched, best_sid, -1),
        best_count,
        torch.where(matched, best_dt, 0),
        torch.where(matched, dedup_best, 0),
    )


class DejavuDeviceMatcher:
    """Batched recognizer over a :class:`DejavuDeviceIndex` on the card.

    :meth:`match_waveforms` takes (B, T) waveforms to per-query top-1
    results in :meth:`Dejavu.align_matches` format in two stages on
    ``device``: the first fingerprints and packs the query hashes and
    reports the widest used hash lane of the batch (one scalar readback);
    the second slices the hash arrays to the smallest power-of-two tier
    covering it and matches them. Lanes past it hold only invalid keys,
    whose cells sort behind every real cell, so the tiered match is
    bit-identical to the full-width one. ``spec_denoiser`` is the UNet hook,
    applied where :func:`fingerprint_spectrogram_batch` applies it.

    ``mesh``: a list of devices (``parallel.make_mesh``) to serve on. A
    batch is then split over them (its size must divide by the mesh size),
    the CSR corpus is put once on each distinct device, each device
    fingerprints and matches its queries with the batch's widest lane
    picking one tier for all, and the results are concatenated,
    bit-identical to one device. With a mesh, ``device`` defaults to the
    mesh's first."""

    def __init__(
        self,
        index: DejavuDeviceIndex,
        settings: Optional[Dict[str, Any]] = None,
        spec_denoiser: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        max_query_frames: int = 512,
        mesh=None,
        device: DeviceLike = None,
    ) -> None:
        self.index = index
        self.settings = _settings(settings)
        self.spec_denoiser = spec_denoiser
        self.max_query_frames = max_query_frames
        self.mesh = None if mesh is None else make_mesh(devices=mesh)
        self.device = resolve_device(device if device is not None or mesh is None else self.mesh[0])
        self.refresh()

    def refresh(self) -> None:
        """(Re-)put the CSR corpus on the devices after new songs."""
        starts, rows, self.nbuckets, self.depth = self.index.finalize()
        host = (torch.from_numpy(starts), torch.from_numpy(rows.astype(np.int64)))
        self._replicas = {
            d: tuple(t.to(d) for t in host) for d in distinct([self.device] + (self.mesh or []))
        }
        self._starts, self._rows = self._replicas[canonical_device(self.device)]
        self.num_ids = max(len(self.index.names), 1)
        offs = rows & np.uint32((1 << self.index.timebits) - 1)
        max_off = int(offs.max()) if rows.size else 0
        self.eff_maxtime = -(-(max_off + 1) // 128) * 128

    def index_bytes(self) -> int:
        """Bytes of the CSR corpus on the device."""
        return self._starts.numel() * 4 + self._rows.numel() * 8

    def _effective_mqf(self, n_frames: int) -> int:
        needed = n_frames + 1
        if needed <= self.max_query_frames:
            return self.max_query_frames
        return -(-needed // 128) * 128

    def _match_kwargs(self, mqf: int) -> Dict[str, int]:
        return dict(
            depth=self.depth, num_ids=self.num_ids, timebits=self.index.timebits,
            mqf=mqf, max_store_time=self.eff_maxtime, nbuckets=self.nbuckets,
        )

    def match_waveforms(
        self, waveforms, max_peaks: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """(B, T) waveforms -> per query an ``align_matches``-format dict
        (empty: no row matched). The ``match`` gate of the file recognizer
        is in :meth:`recognize_waveforms`."""
        wavs = torch.as_tensor(waveforms, dtype=torch.float32)
        n_frames = _n_frames(wavs.shape[1], self.settings)
        mp = max_peaks or _pow2ceil(4 * n_frames)
        shards = (
            [((0, wavs.shape[0]), self.device)] if self.mesh is None
            else list(zip(shard_bounds(wavs.shape[0], self.mesh), self.mesh))
        )
        return self._match_shards([
            (dev, fingerprint_and_pack(wavs[lo:hi].to(dev), self.settings, mp,
                                       denoiser=self.spec_denoiser))
            for (lo, hi), dev in shards
        ], n_frames)

    def match_packed(self, packed, n_frames: int) -> List[Dict[str, Any]]:
        """:func:`pack_hashes_from_masks`' output for B queries of
        ``n_frames`` frames, on this matcher's device -> per query an
        ``align_matches``-format dict, through the lane tier."""
        return self._match_shards([(self.device, packed)], n_frames)

    def _match_shards(self, shards, n_frames: int) -> List[Dict[str, Any]]:
        """(device, packed hashes) of each slice of a batch -> the batch's
        results: one lane tier for the batch (one scalar a device), then
        each slice matched against its device's corpus and read back in one
        copy."""
        st = self.settings
        B = sum(int(p[0].shape[0]) for _, p in shards)
        if int(self._rows.shape[0]) == 0:  # empty corpus: no row matches
            return [{} for _ in range(B)]
        # widest used lane: every in-range key (valid or a (key, t1)
        # duplicate) sorts before the invalid ones
        n_used = max(int((p[0] < INVALID_KEY).sum(dim=-1).max()) for _, p in shards)
        width = int(shards[0][1][0].shape[1])
        h_tier = min(width, _pow2ceil(max(n_used, 128)))
        kwargs = self._match_kwargs(self._effective_mqf(n_frames))
        parts, n_over = [], 0
        for dev, (keys, t1, valid, kf, n_distinct, over) in shards:
            out = _dejavu_match_impl(
                *self._replicas[canonical_device(dev)], keys[:, :h_tier], t1[:, :h_tier],
                valid[:, :h_tier], kf[:, :h_tier], **kwargs,
            )
            host = torch.cat([torch.stack(list(out) + [n_distinct]).flatten(),
                              over.reshape(1).to(torch.int32)]).cpu().numpy()
            parts.append(host[:-1].reshape(5, -1))
            n_over += int(host[-1])
        best_sid, best_count, best_dt, dedup_best, n_distinct = np.concatenate(parts, axis=1)
        _warn_overflow(n_over, B, width // (int(st["fan_value"]) - 1), "queries")
        results: List[Dict[str, Any]] = []
        for i in range(B):
            if best_sid[i] < 0:
                results.append({})
                continue
            sid = int(best_sid[i])
            song_hashes = self.index.total_hashes[sid]
            queried = max(int(n_distinct[i]), 1)
            hashes_matched = int(dedup_best[i])
            results.append(
                {
                    SONG_ID: sid,
                    SONG_NAME: self.index.names[sid].encode("utf8"),
                    INPUT_HASHES: int(n_distinct[i]),
                    FINGERPRINTED_HASHES: song_hashes,
                    HASHES_MATCHED: hashes_matched,
                    INPUT_CONFIDENCE: round(hashes_matched / queried, 2),
                    INPUT_CONFIDENCE_2: round(int(best_count[i]) / queried, 2),
                    "nb_matches_with_offset": int(best_count[i]),
                    FINGERPRINTED_CONFIDENCE: round(hashes_matched / max(song_hashes, 1), 2),
                    OFFSET: int(best_dt[i]),
                    OFFSET_SECS: round(float(best_dt[i]) / st["samplerate"] * st["n_hop"], 5),
                    "file_sha1": b"",
                }
            )
        return results

    def recognize_waveforms(
        self, waveforms, max_peaks: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """File-recognizer verdicts: ``{"results": [top1...], "match":
        bool}`` per query, ``match`` when the top song's aligned count
        exceeds ``MIN_HASHES``."""
        out = []
        for r in self.match_waveforms(waveforms, max_peaks=max_peaks):
            if r:
                out.append({"results": [r], "match": r["nb_matches_with_offset"] > MIN_HASHES})
            else:
                out.append({"results": [], "match": False})
        return out

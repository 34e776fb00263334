"""Fingerprint query matching on the host (numpy copy of
musicfpaugment_tpu/afp/audfprint/matcher.py, which has no JAX in it).

The matcher consumes hit lists from :class:`HashTable` and ranks reference
tracks by time-consistent hash counts, query by query: the oracle behind
:class:`DeviceMatcher`, and the sequential path of the evaluation harness.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from musicfpaugment_torch.afp.audfprint.hash_table import HashTable


def encpowerof2(val: float) -> int:
    """N s.t. 2^N >= val."""
    return int(np.ceil(np.log(max(1, val)) / np.log(2)))


def locmax(vec: np.ndarray, indices: bool = False) -> np.ndarray:
    """Local maxima with the reference's end-point semantics."""
    nbr = np.zeros(len(vec) + 1, dtype=bool)
    nbr[0] = True
    nbr[1:-1] = np.greater_equal(vec[1:], vec[:-1])
    maxmask = nbr[:-1] & ~nbr[1:]
    if indices:
        return np.nonzero(maxmask)[0]
    return maxmask


def keep_local_maxes(vec: np.ndarray) -> np.ndarray:
    """Zero out non-local-max values."""
    out = np.zeros(vec.shape, dtype=np.float32)
    idx = locmax(vec, indices=True)
    out[idx] = vec[idx]
    return out


def find_modes(data: np.ndarray, threshold: int = 5) -> Tuple[np.ndarray, np.ndarray]:
    """Local-max modes with count >= threshold."""
    datamin = np.amin(data)
    fullvector = np.bincount(data - datamin)
    localmaxes = np.nonzero(
        np.logical_and(locmax(fullvector), np.greater_equal(fullvector, threshold))
    )[0]
    return localmaxes + datamin, fullvector[localmaxes]


class Matcher:
    """The reference matcher, same defaults."""

    def __init__(self) -> None:
        self.window = 2
        self.threshcount = 5
        self.max_returns = 1
        self.search_depth = 100
        self.sort_by_time = False
        self.verbose = 1
        self.exact_count = False
        self.find_time_range = False
        self.time_quantile = 0.05
        self.max_alignments_per_id = 100

    # ------------------------------------------------------------ internals

    def _best_count_ids(self, hits: np.ndarray, ht: HashTable):
        """The ids with the best hashesperid-weighted raw hit counts, at most
        ``search_depth`` of those past ``threshcount``, with their raw counts."""
        allids = hits[:, 0]
        ids = np.unique(allids)
        rawcounts = np.bincount(allids)[ids]
        wtdcounts = rawcounts / ht.hashesperid[ids].astype(float)
        bestcountsixs = np.argsort(wtdcounts)[::-1]
        maxdepth = np.minimum(
            np.count_nonzero(np.greater(rawcounts, self.threshcount)),
            self.search_depth,
        )
        bestcountsixs = bestcountsixs[:maxdepth]
        return ids[bestcountsixs], rawcounts[bestcountsixs]

    def _unique_match_hashes(self, id: int, hits: np.ndarray, mode: float):
        """Unique (time, hash) rows of ``id``'s hits within ``window`` of
        ``mode``."""
        allids = hits[:, 0]
        alltimes = hits[:, 1]
        allhashes = hits[:, 2].astype(np.int64)
        allotimes = hits[:, 3]
        timebits = max(1, encpowerof2(np.amax(allotimes)))
        matchix = np.nonzero(
            np.logical_and(
                allids == id, np.less_equal(np.abs(alltimes - mode), self.window)
            )
        )[0]
        matchhasheshash = np.unique(
            allotimes[matchix] + (allhashes[matchix] << timebits)
        )
        timemask = (1 << timebits) - 1
        return np.stack(
            [matchhasheshash & timemask, matchhasheshash >> timebits], axis=1
        )

    def _calculate_time_ranges(self, hits: np.ndarray, id: int, mode: float):
        """Quantile time range of ``id``'s hits within ``window`` of ``mode``."""
        minoffset = mode - self.window
        maxoffset = mode + self.window
        match_times = hits[
            np.logical_and.reduce(
                [hits[:, 1] >= minoffset, hits[:, 1] <= maxoffset, hits[:, 0] == id]
            ),
            3,
        ]
        min_time = match_times[int(len(match_times) * self.time_quantile)]
        max_time = match_times[int(len(match_times) * (1.0 - self.time_quantile)) - 1]
        return min_time, max_time

    def _exact_match_counts(self, hits, ids, rawcounts):
        """Time-consistent counts via unique-hash filtering."""
        sorted_hits = hits[hits[:, 3].argsort()]
        allids = sorted_hits[:, 0]
        alltimes = sorted_hits[:, 1]
        results: List[List[int]] = []
        min_time = 0
        max_time = 0
        for urank, (id, rawcount) in enumerate(zip(ids, rawcounts)):
            modes, _ = find_modes(
                alltimes[np.nonzero(allids == id)[0]], threshold=self.threshcount
            )
            for mode in modes:
                matchhashes = self._unique_match_hashes(id, sorted_hits, mode)
                filtcount = len(matchhashes)
                if filtcount >= self.threshcount:
                    if self.find_time_range:
                        min_time, max_time = self._calculate_time_ranges(
                            sorted_hits, id, mode
                        )
                    results.append(
                        [id, filtcount, mode, rawcount, urank, min_time, max_time]
                    )
        return np.asarray(results, np.int32).reshape(-1, 7)

    def _approx_match_counts(self, hits, ids, rawcounts):
        """Bincount-of-offsets approximate counting."""
        results: List[List[int]] = []
        if not hits.size:
            return np.zeros((len(ids), 7), np.int32)[:0]
        sorted_hits = hits[hits[:, 3].argsort()]
        allids = sorted_hits[:, 0].astype(int)
        alltimes = sorted_hits[:, 1].astype(int)
        mintime = np.amin(alltimes)
        alltimes = alltimes - mintime
        min_time = 0
        max_time = 0
        for urank, (id, rawcount) in enumerate(zip(ids, rawcounts)):
            id = int(id)
            bincounts = np.bincount(alltimes[allids == id])
            filtered_bincounts = keep_local_maxes(bincounts)
            found_this_id = 0
            while True:
                mode = int(np.argmax(filtered_bincounts))
                if filtered_bincounts[mode] <= self.threshcount:
                    break
                count = int(
                    np.sum(
                        bincounts[max(0, mode - self.window) : mode + self.window + 1]
                    )
                )
                if self.find_time_range:
                    min_time, max_time = self._calculate_time_ranges(
                        sorted_hits, id, mode + mintime
                    )
                results.append(
                    [id, count, mode + mintime, rawcount, urank, min_time, max_time]
                )
                filtered_bincounts[
                    max(0, mode - self.window) : mode + self.window + 1
                ] = 0
                found_this_id += 1
                if found_this_id > self.max_alignments_per_id:
                    break
        return np.asarray(results, np.int32).reshape(-1, 7)

    # ------------------------------------------------------------ API

    def match_hashes(
        self, ht: HashTable, hashes: np.ndarray, hashesfor: Optional[int] = None
    ):
        """Top matches as rows of [id, filt_count, time_skew, raw_count,
        orig_rank, min_time, max_time]."""
        hits = ht.get_hits(hashes)
        if hits.shape[0] == 0:
            empty = np.zeros((0, 7), np.int32)
            return (empty, None) if hashesfor is None else (empty, empty)
        bestids, rawcounts = self._best_count_ids(hits, ht)
        if not self.exact_count:
            results = self._approx_match_counts(hits, bestids, rawcounts)
        else:
            results = self._exact_match_counts(hits, bestids, rawcounts)
        results = results[(-results[:, 1]).argsort()]
        if hashesfor is None:
            return results, None
        id = results[hashesfor, 0]
        mode = results[hashesfor, 2]
        hashesforhashes = self._unique_match_hashes(id, hits, mode)
        return results, hashesforhashes

    def match_file(
        self, analyzer: Any, ht: HashTable, filename: str
    ) -> Tuple[np.ndarray, float, int]:
        """(top result rows, query duration in seconds, number of hashes) of
        one file through ``analyzer.wavfile2hashes``."""
        q_hashes = analyzer.wavfile2hashes(filename)
        if len(q_hashes) == 0:
            durd = 0.0
        else:
            durd = analyzer.n_hop * q_hashes[-1][0] / analyzer.target_sr
        rslts, _ = self.match_hashes(ht, q_hashes)
        if self.sort_by_time:
            rslts = rslts[(-rslts[:, 2]).argsort(), :]
        return rslts[: self.max_returns, :], durd, len(q_hashes)

    def file_match_to_msgs(
        self, analyzer: Any, ht: HashTable, qry: str
    ) -> Tuple[str, str, int]:
        """("MATCH"|"NOMATCH", name, aligned-hash count)."""
        rslts, dur, nhash = self.match_file(analyzer, ht, qry)
        if len(rslts) == 0:
            return "NOMATCH", "", 0
        tophitid = rslts[-1, 0]
        nhashaligned = int(rslts[-1, 1])
        return "MATCH", ht.names[tophitid], nhashaligned

    def hashes_match_to_msgs(
        self, ht: HashTable, q_hashes: np.ndarray
    ) -> Tuple[str, str, int]:
        """Batched-friendly variant: match pre-computed query hashes."""
        rslts, _ = self.match_hashes(ht, q_hashes)
        rslts = rslts[: self.max_returns]
        if len(rslts) == 0:
            return "NOMATCH", "", 0
        return "MATCH", ht.names[rslts[-1, 0]], int(rslts[-1, 1])

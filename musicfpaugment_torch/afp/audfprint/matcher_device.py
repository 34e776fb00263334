"""Batched device-side fingerprint matching (port of
musicfpaugment_tpu/afp/audfprint/matcher_device.py).

The hash table lives on the device sliced to its effective depth; a batch of
queries is matched by gathering every hit, sorting once by a packed
(id, dt) key, and working in sorted order: id-run lengths are the raw
counts, candidates are the best hashesperid-weighted ids past the
``threshcount`` gate, a second sort compacts the candidates' distinct
(id, dt) cells, and the windowed counts, local-max modes and the verdict
come from +-window neighbour shifts over that short slice. Outputs are
bit-identical to the JAX ``_match_impl`` (tests/test_torch_matcher.py).

Differences of form: the device table is int32 (values stay below 2^31
while ids fit in 31 - maxtimebits bits, checked in ``refresh``); sort keys
are int64; ``lax.top_k`` becomes a stable descending sort (ties to the lower
position, as ``top_k``); the candidate-rank loop becomes one lookup table.
"""

from __future__ import annotations

import warnings
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint import landmarks as lm
from musicfpaugment_torch.afp.audfprint.hash_table import HashTable
from musicfpaugment_torch.afp.audfprint.peaks import find_peaks_shifts
from musicfpaugment_torch.device import DeviceLike, resolve_device


def _run_length(sorted_vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K) sorted rows -> (start mask, run length at each start
    position). Lengths at non-start positions are meaningless."""
    B, K = sorted_vals.shape
    start = torch.ones_like(sorted_vals, dtype=torch.bool)
    start[:, 1:] = sorted_vals[:, 1:] != sorted_vals[:, :-1]
    pos = torch.arange(K, device=sorted_vals.device).expand(B, K)
    start_pos = torch.where(start, pos, K)
    nxt = torch.cummin(start_pos.flip(-1), dim=1).values.flip(-1)
    nxt_after = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], K)], dim=1)
    return start, (nxt_after - pos).to(torch.int32)


def _shifted(x: torch.Tensor, off: int, fill) -> torch.Tensor:
    """Row shift: value at slot k - off (off > 0) or k + |off| (off < 0)."""
    pad = torch.full_like(x[:, : abs(off)], fill)
    if off > 0:
        return torch.cat([pad, x[:, :-off]], dim=1)
    return torch.cat([x[:, -off:], pad], dim=1)


def _match_impl(
    table: torch.Tensor,
    counts: torch.Tensor,
    hpi_table: torch.Tensor,
    qtimes: torch.Tensor,
    qhashes: torch.Tensor,
    qvalid: torch.Tensor,
    *,
    depth: int,
    num_ids: int,
    max_candidates: int,
    window: int,
    threshcount: int,
    maxtimebits: int,
    max_query_frames: int,
    max_store_time: Optional[int] = None,
    cell_budget: int = 16384,
):
    """qtimes/qhashes/qvalid: (B, H). Returns (best_id, best_count,
    best_mode, cell_overflow); best_id == -1 means NOMATCH, cell_overflow
    counts queries whose candidate cells exceeded ``cell_budget``."""
    B, H = qhashes.shape
    dev = qhashes.device
    D = depth
    K = H * D
    C = min(max_candidates, K)  # a short query over a shallow table
    T = (max_store_time or (1 << maxtimebits)) + max_query_frames
    T2 = T + 1  # dt slot T = defensive overflow, never scored
    timemask = (1 << maxtimebits) - 1

    qh = qhashes.long()
    tab = table[qh]  # (B, H, D) int32
    nvalid = counts[qh]  # (B, H)
    hpit = hpi_table[qh]  # (B, H, D) f32: weights ride the gather
    slot_ok = torch.arange(D, device=dev) < nvalid[..., None]
    hit_ok = slot_ok & qvalid[..., None]
    ids = (tab >> maxtimebits) - 1
    dtq = (tab & timemask) - qtimes[..., None] + max_query_frames
    dtq = torch.clamp(dtq, 0, T)
    sentinel = num_ids * T2
    hit_key = torch.where(
        hit_ok, ids.long() * T2 + dtq.long(), sentinel
    ).reshape(B, K)
    payload = torch.where(hit_ok, hpit, 0.0).reshape(B, K)
    # equal keys share the id, hence the payload: any order among them works
    s, order = torch.sort(hit_key, dim=-1, stable=True)
    hpi_at = torch.gather(payload, 1, order)

    pos = torch.arange(K, device=dev).expand(B, K)
    cell_id = s // T2
    in_corpus = cell_id < num_ids  # sentinel run excluded

    # ---- per-id raw counts: run length of the id-run starting here
    id_start, raw_at = _run_length(cell_id)

    # ---- candidate selection at id-run starts (gate: raw > threshcount)
    w_start = torch.where(
        id_start & in_corpus & (raw_at > threshcount),
        raw_at.to(torch.float32) / torch.clamp(hpi_at, min=1.0),
        -1.0,
    )
    # lax.top_k order: descending, ties to the lower position
    top_w, top_pos = torch.sort(w_start, dim=-1, descending=True, stable=True)
    top_w, top_pos = top_w[:, :C], top_pos[:, :C]
    cand_ok = top_w > 0.0
    cand = torch.gather(cell_id, 1, top_pos)  # (B, C) ids, unique per row

    # ---- rank of each hit's id in the candidate list, by lookup table
    # (column num_ids takes the sentinel run and the unused candidates)
    lut = torch.full((B, num_ids + 1), -1, dtype=torch.long, device=dev)
    lut.scatter_(
        1,
        torch.where(cand_ok, cand, num_ids),
        torch.arange(C, device=dev).expand(B, C),
    )
    lut[:, num_ids] = -1
    rank_raw = torch.gather(lut, 1, torch.clamp(cell_id, max=num_ids))
    is_cand = rank_raw >= 0
    rank = torch.clamp(rank_raw, min=0)

    # ---- compact the candidates' distinct (id, dt) cells to the row
    # front, ordered by (candidate rank, dt); run lengths as payload
    cell_start, cell_len = _run_length(s)
    rem = s - cell_id * T2
    keep_cell = cell_start & in_corpus & is_cand
    big32 = 2**31 - 1
    ckey = torch.where(keep_cell, rank * T2 + rem, big32)
    S = min(cell_budget, K)
    k2, order2 = torch.sort(ckey, dim=-1, stable=True)
    k2 = k2[:, :S]
    clen = torch.gather(cell_len, 1, order2[:, :S])
    cell_overflow = int((keep_cell.sum(dim=1) > S).sum())
    present = k2 < big32
    crank = torch.where(present, k2 // T2, C)
    cdt = torch.where(present, k2 - (k2 // T2) * T2, T)
    clen = torch.where(present & (cdt < T), clen, 0)

    # ---- windowed counts + local-max modes via +-window neighbour shifts:
    # a candidate's cells are consecutive and dt-sorted
    wcount = clen
    hist_prev1 = torch.zeros_like(clen)
    hist_next1 = torch.zeros_like(clen)
    for o in range(1, window + 1):
        crank_p, cdt_p, len_p = (
            _shifted(crank, o, -1), _shifted(cdt, o, 0), _shifted(clen, o, 0)
        )
        same_p = (crank_p == crank) & (cdt_p >= cdt - window)
        wcount = wcount + torch.where(same_p, len_p, 0)
        crank_n, cdt_n, len_n = (
            _shifted(crank, -o, -1), _shifted(cdt, -o, 0), _shifted(clen, -o, 0)
        )
        same_n = (crank_n == crank) & (cdt_n <= cdt + window)
        wcount = wcount + torch.where(same_n, len_n, 0)
        if o == 1:  # exact +-1 neighbours for the local-max test
            hist_prev1 = torch.where((crank_p == crank) & (cdt_p == cdt - 1), len_p, 0)
            hist_next1 = torch.where((crank_n == crank) & (cdt_n == cdt + 1), len_n, 0)
    modes = (clen >= hist_prev1) & (clen > hist_next1) & (clen > threshcount)

    # ---- verdict: argmax (first wins) over a packed (wcount, rank) score
    bits = max(C, 2).bit_length()
    score = torch.where(
        modes & present,
        (wcount.long() << bits) + (((1 << bits) - 1) - crank),
        0,
    )
    best_pos = torch.argmax(score, dim=-1, keepdim=True)  # (B, 1)
    best_count = (torch.gather(score, 1, best_pos)[:, 0] >> bits).to(torch.int32)
    best_rank = torch.gather(crank, 1, best_pos)[:, 0]
    cand_sent = torch.where(cand_ok, cand, -1_000_000)
    best_id = torch.gather(cand_sent, 1, torch.clamp(best_rank, 0, C - 1)[:, None])[:, 0]
    best_mode = (torch.gather(cdt, 1, best_pos)[:, 0] - max_query_frames).to(torch.int32)
    best_id = torch.where(best_count > 0, best_id, -1).to(torch.int32)
    return best_id, best_count, best_mode, cell_overflow


class DeviceMatcher:
    """Batched matcher over a device-resident copy of a :class:`HashTable`.

    Defaults follow the reference matcher (window 2, threshcount 5, search
    depth 100). ``max_candidates`` bounds the per-query candidate set
    (default ``search_depth``, clipped to the corpus size);
    ``max_query_frames`` is the floor of the negative-offset range, raised
    per call to cover the query. ``device=None`` means CUDA and raises
    without it unless ``device="cpu"``."""

    def __init__(
        self,
        hash_table: HashTable,
        max_candidates: Optional[int] = None,
        window: int = 2,
        threshcount: int = 5,
        max_query_frames: int = 512,
        search_depth: int = 100,
        cell_budget: int = 16384,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.ht = hash_table
        self.window = window
        self.threshcount = threshcount
        self.cell_budget = cell_budget
        self.max_candidates = (
            max_candidates if max_candidates is not None else search_depth
        )
        self.max_query_frames = max_query_frames
        self.maxtimebits = hash_table.maxtimebits
        self.refresh()

    def refresh(self) -> None:
        """Re-upload the table after host-side ``store`` calls: sliced to the
        effective depth (deepest bucket in use), with the effective time
        range and the slot-aligned hashesperid mirror."""
        self.num_ids = max(len(self.ht.names), 1)
        if (self.num_ids + 1) << self.maxtimebits > 2**31:
            raise ValueError(
                f"{self.num_ids} ids do not fit the int32 device table "
                f"with maxtimebits={self.maxtimebits}"
            )
        counts_clipped = np.minimum(self.ht.counts, self.ht.depth).astype(np.int32)
        self.eff_depth = int(max(1, counts_clipped.max())) if counts_clipped.size else 1
        table_slice = self.ht.table[:, : self.eff_depth]
        self._table = torch.from_numpy(table_slice.astype(np.int32)).to(self.device)
        self._counts = torch.from_numpy(counts_clipped).to(self.device)
        timemask = (1 << self.maxtimebits) - 1
        used = np.arange(self.eff_depth)[None, :] < counts_clipped[:, None]
        stored_times = (table_slice & np.uint32(timemask))[used]
        max_time = int(stored_times.max()) if stored_times.size else 0
        self.eff_maxtime = -(-(max_time + 1) // 128) * 128
        hpi = np.maximum(np.asarray(self.ht.hashesperid, np.float32), 1.0)
        hpi_pad = np.pad(hpi, (0, self.num_ids - len(hpi)), constant_values=1.0)
        # hpi of the id stored in each slot: the weight rides the hit gather
        slot_ids = (table_slice >> np.uint32(self.maxtimebits)).astype(np.int64) - 1
        self._hpit = torch.from_numpy(
            hpi_pad[np.clip(slot_ids, 0, self.num_ids - 1)].astype(np.float32)
        ).to(self.device)

    def table_bytes(self) -> int:
        """Bytes of the device-resident table, counts and hpi mirror."""
        return sum(t.numel() * t.element_size() for t in (self._table, self._counts, self._hpit))

    def _match_kwargs(self, max_query_frames: int) -> dict:
        return dict(
            depth=self.eff_depth,
            num_ids=self.num_ids,
            max_candidates=min(self.max_candidates, self.num_ids),
            window=self.window,
            threshcount=self.threshcount,
            maxtimebits=self.maxtimebits,
            max_query_frames=max_query_frames,
            max_store_time=self.eff_maxtime,
            cell_budget=self.cell_budget,
        )

    def _effective_mqf(self, max_qtime: int) -> int:
        """max_query_frames covering queries whose largest time is
        ``max_qtime``: the floor, raised in 128-frame steps."""
        needed = max_qtime + 1
        if needed <= self.max_query_frames:
            return self.max_query_frames
        return -(-needed // 128) * 128

    def _verdicts(self, best_id, best_count, cell_overflow: int, B: int):
        if cell_overflow:
            warnings.warn(
                f"{cell_overflow}/{B} queries exceeded the "
                f"{self.cell_budget}-candidate-cell budget (lowest-ranked "
                "cells dropped); raise cell_budget if this is expected",
                stacklevel=3,
            )
        best_id = best_id.cpu().numpy()
        best_count = best_count.cpu().numpy()
        return [
            ("NOMATCH", "", 0)
            if best_id[i] < 0
            else ("MATCH", self.ht.names[int(best_id[i])], int(best_count[i]))
            for i in range(B)
        ]

    def match_waveforms(
        self,
        waveforms,
        *,
        shifts: int = 1,
        density: float = 20.0,
        n_fft: int = 512,
        n_hop: int = 256,
        f_sd: float = 30.0,
        maxpksperframe: int = 5,
        denoiser=None,
        max_query_hashes: int = 4096,
        valid_samples=None,
    ) -> List[Tuple[str, Any, int]]:
        """Waveforms -> verdicts on the device: peaks for every shift (the
        shifts stacked into one batch, so each prune runs once per call),
        landmark hashes, cross-shift dedup and compaction, then the match.
        Only one scalar (the widest query's hash count, which picks the
        power-of-two lane tier) and the verdicts come back to the host.

        The per-query hash budget is ``min(max_query_hashes,
        pow2ceil(3 * n_frames * shifts))``; a query past it is truncated
        after dedup, earliest hashes kept, with a warning.
        ``valid_samples`` (B,) marks real lengths of a batch stacked by
        ``analyzer.pad_waveform_batch``. ``denoiser`` is a spectrogram
        denoiser (``convert.unet_denoiser``), called once per shift on that
        shift's normalised magnitudes."""
        waveforms = torch.as_tensor(waveforms, dtype=torch.float32, device=self.device)
        B, T = waveforms.shape
        n_frames = 1 + T // n_hop
        mqf = self._effective_mqf(n_frames - 1)
        n_shifts = max(1, shifts)
        budget = min(
            max_query_hashes,
            1 << int(np.ceil(np.log2(max(3 * n_frames * n_shifts, 64)))),
        )
        vsamp = None
        if valid_samples is not None:
            vsamp = torch.as_tensor(valid_samples, dtype=torch.int32, device=self.device)

        # every shift's peaks from one forward and one backward prune
        masks_by_shift = find_peaks_shifts(
            waveforms,
            n_shifts,
            density=density,
            n_fft=n_fft,
            n_hop=n_hop,
            f_sd=f_sd,
            maxpksperframe=maxpksperframe,
            valid_samples=vsamp,
            denoiser=denoiser,
        )
        th_parts, valid_parts = [], []
        for masks in masks_by_shift:
            C = int(masks.shape[-1])
            max_peaks = -(-maxpksperframe * C // 128) * 128
            th, v = lm.hashes_from_masks_batched(
                masks, max_peaks=max_peaks, max_hashes=max_peaks * lm.MAXPAIRSPERPEAK
            )
            th_parts.append(th)
            valid_parts.append(v)
        th = torch.cat(th_parts, dim=1)
        valid = torch.cat(valid_parts, dim=1)
        t, h, v = lm.sort_dedup_hashes(th[..., 0], th[..., 1], valid)
        n = min(budget, t.shape[-1])
        t, h, nv = lm.compact_valid_first(t, h, v, out_len=n)
        # one scalar readback picks the lane tier
        n_used = int(torch.clamp(nv, max=n).max())
        n_overflow = int((nv > n).sum())
        h_tier = min(n, 1 << int(np.ceil(np.log2(max(n_used, 64)))))
        vq = torch.arange(h_tier, device=self.device) < torch.clamp(nv, max=h_tier)[:, None]
        best_id, best_count, _, cell_overflow = _match_impl(
            self._table, self._counts, self._hpit,
            t[:, :h_tier], h[:, :h_tier], vq, **self._match_kwargs(mqf),
        )
        if n_overflow:
            warnings.warn(
                f"{n_overflow}/{B} queries exceeded the {budget}-hash "
                "budget and were truncated (earliest hashes kept); pass a "
                "larger max_query_hashes if this is expected",
                stacklevel=2,
            )
        return self._verdicts(best_id, best_count, cell_overflow, B)

    def match_hashes_batch(
        self, hashes_list: Sequence[np.ndarray]
    ) -> List[Tuple[str, Any, int]]:
        """Match B queries' (time, hash) arrays in one batch; returns per
        query ("MATCH" | "NOMATCH", name, aligned count)."""
        B = len(hashes_list)
        if B == 0:
            return []
        H = max(max(len(h) for h in hashes_list), 1)
        Hpad = 1 << int(np.ceil(np.log2(max(H, 64))))
        qt = np.zeros((B, Hpad), np.int32)
        qh = np.zeros((B, Hpad), np.int32)
        qv = np.zeros((B, Hpad), bool)
        for i, h in enumerate(hashes_list):
            n = len(h)
            if n:
                arr = np.asarray(h)
                qt[i, :n] = arr[:, 0]
                qh[i, :n] = arr[:, 1] & ((1 << self.ht.hashbits) - 1)
                qv[i, :n] = True
        best_id, best_count, _, cell_overflow = _match_impl(
            self._table, self._counts, self._hpit,
            torch.from_numpy(qt).to(self.device),
            torch.from_numpy(qh).to(self.device),
            torch.from_numpy(qv).to(self.device),
            **self._match_kwargs(self._effective_mqf(int(qt.max(initial=0)))),
        )
        return self._verdicts(best_id, best_count, cell_overflow, B)

"""Peak-pair landmarks and 20-bit hash packing (port of
musicfpaugment_tpu/afp/audfprint/landmarks.py).

Peaks come out of a (F, C) mask, or each mask of a (B, F, C) batch, in
(column, bin) order into a fixed-size padded array, each peak looks at the
next ``window`` peaks, and the fanout cap ("first ``MAXPAIRSPERPEAK`` valid
candidates") is a running count. The single-example chain
(:func:`extract_peaks`, :func:`pair_landmarks`, :func:`pair_hashes`,
:func:`hashes_from_mask`) and the batched :func:`hashes_from_masks_batched`
give the same hashes; both are bit-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# hash construction constants
MAXPAIRSPERPEAK = 3
MINDT = 2
TARGETDT = 63
TARGETDF = 31

_I32_MAX = 2**31 - 1


def _first_nonzero(flat: torch.Tensor, size: int) -> torch.Tensor:
    """Row-wise ``jnp.nonzero(row, size=size, fill_value=-1)`` without a
    host sync: each set position's slot is its running count, written by a
    scatter into a buffer one column wider (the extra column takes every
    write that does not fit) and then sliced."""
    B, N = flat.shape
    rank = torch.cumsum(flat.to(torch.int32), dim=1) - 1
    tgt = torch.where(flat & (rank < size), rank, size).long()
    pos = torch.arange(N, device=flat.device).expand(B, N)
    out = torch.full((B, size + 1), -1, dtype=torch.long, device=flat.device)
    out.scatter_(1, tgt, torch.where(tgt < size, pos, -1))
    return out[:, :size]


def extract_peaks(mask: torch.Tensor, max_peaks: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(F, C) boolean mask -> (cols, bins, valid) int32/int32/bool, padded
    to ``max_peaks`` and sorted by (column, bin); padding slots hold (0, 0)."""
    F, C = mask.shape
    flat = mask.transpose(0, 1).reshape(1, -1)  # column-major
    idx = _first_nonzero(flat, max_peaks)[0]
    valid = idx >= 0
    safe = torch.where(valid, idx, 0)
    return (safe // F).to(torch.int32), (safe % F).to(torch.int32), valid


def _pair_grid(
    cols: torch.Tensor, bins: torch.Tensor, valid: torch.Tensor, window: int,
    mindt: int, targetdt: int, targetdf: int, maxpairs: int,
):
    """The (P, window) candidate grid of peak i against peak i + 1 + w:
    (bin of the candidate, dt, df, selected)."""
    P = cols.shape[0]
    dev = cols.device
    j = torch.arange(P, device=dev)[:, None] + torch.arange(1, window + 1, device=dev)[None, :]
    in_range = j < P
    j_safe = torch.where(in_range, j, P - 1)
    bin_j = bins[j_safe]
    dt = cols[j_safe] - cols[:, None]
    df = bin_j - bins[:, None]
    ok = (
        valid[:, None]
        & (valid[j_safe] & in_range)
        & (dt >= mindt)
        & (dt < targetdt)
        & (df.abs() < targetdf)
    )
    # "first maxpairs valid candidates" in j order
    rank = torch.cumsum(ok.to(torch.int32), dim=1)
    return bin_j, dt, df, ok & (rank <= maxpairs)


def pair_landmarks(
    cols: torch.Tensor,
    bins: torch.Tensor,
    valid: torch.Tensor,
    window: int = 320,
    mindt: int = MINDT,
    targetdt: int = TARGETDT,
    targetdf: int = TARGETDF,
    maxpairs: int = MAXPAIRSPERPEAK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair each peak with up to ``maxpairs`` of the next ``window`` peaks:
    (landmarks (P, window, 4) int32 [col, bin1, bin2, dt], selected
    (P, window) bool)."""
    bin_j, dt, _, selected = _pair_grid(
        cols, bins, valid, window, mindt, targetdt, targetdf, maxpairs
    )
    landmarks = torch.stack(
        [cols[:, None].expand_as(dt), bins[:, None].expand_as(dt), bin_j, dt], dim=-1
    ).to(torch.int32)
    return landmarks, selected


def pair_hashes(
    cols: torch.Tensor,
    bins: torch.Tensor,
    valid: torch.Tensor,
    window: int = 320,
    mindt: int = MINDT,
    targetdt: int = TARGETDT,
    targetdf: int = TARGETDF,
    maxpairs: int = MAXPAIRSPERPEAK,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`pair_landmarks` with the 20-bit hash packed from dt and df
    directly: (times (P, W), hashes (P, W), selected (P, W))."""
    _, dt, df, selected = _pair_grid(
        cols, bins, valid, window, mindt, targetdt, targetdf, maxpairs
    )
    h = ((bins[:, None] & 255) << 12) | ((df & 63) << 6) | (dt & 63)
    return cols[:, None].expand_as(h), h, selected


def landmarks_to_hashes(landmarks: torch.Tensor) -> torch.Tensor:
    """(..., 4) [col, bin1, bin2, dt] -> (..., 2) [time, 20-bit hash]."""
    time, bin1, bin2, dt = landmarks.unbind(-1)
    h = ((bin1 & 255) << 12) | (((bin2 - bin1) & 63) << 6) | (dt & 63)
    return torch.stack([time, h], dim=-1)


def hashes_from_mask(
    mask: torch.Tensor, max_peaks: int, max_hashes: int, window: int = 320
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(F, C) peak mask -> ((max_hashes, 2) int32 (time, hash) rows sorted
    by (time, hash) with the invalid rows last, valid (max_hashes,) bool
    marking the first of each distinct row). A padding row holds the values
    of the grid's first cell, as in the JAX package."""
    cols, bins, valid = extract_peaks(mask, max_peaks)
    times, hashes, selected = pair_hashes(cols, bins, valid, window=window)
    th = torch.stack([times.reshape(-1), hashes.reshape(-1)], dim=-1)
    # the selected pairs, in grid order, into a fixed-size buffer
    idx = _first_nonzero(selected.reshape(1, -1), max_hashes)[0]
    lvalid = idx >= 0
    th = th[torch.where(lvalid, idx, 0)]
    # sort by (time, hash): a stable sort by hash, then by time
    order_h = torch.sort(th[:, 1], stable=True).indices
    th, lvalid = th[order_h], lvalid[order_h]
    order_t = torch.sort(torch.where(lvalid, th[:, 0], _I32_MAX), stable=True).indices
    th, lvalid = th[order_t], lvalid[order_t]
    same = (th[1:, 0] == th[:-1, 0]) & (th[1:, 1] == th[:-1, 1]) & lvalid[1:]
    unique = torch.cat([torch.ones(1, dtype=torch.bool, device=th.device), ~same])
    return th, lvalid & unique


def _lookahead(x: torch.Tensor, window: int, fill) -> torch.Tensor:
    """(B, P) -> (B, P, window) float32, out[b, i, w] = x[b, i + 1 + w]
    (``fill`` past the end); the values (columns, bins, flags) are exact in
    float32, which the JAX package's sliding-window patches return."""
    B, P = x.shape
    xpad = torch.cat([x, torch.full((B, window), fill, dtype=x.dtype, device=x.device)], dim=1)
    return xpad[:, 1:].unfold(1, window, 1)[:, :P].to(torch.float32)


def sort_dedup_hashes(
    times: torch.Tensor, hashes: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row (time, hash) ascending sort with invalid rows last, plus a
    consecutive-duplicate mask. One stable sort on a packed int64
    (time, hash) key; equal keys carry equal payloads, so the order among
    them does not show."""
    k1 = torch.where(valid, times, _I32_MAX).long()
    k2 = torch.where(valid, hashes, _I32_MAX).long()
    _, order = torch.sort((k1 << 32) + k2, dim=-1, stable=True)
    times = torch.gather(times, -1, order)
    hashes = torch.gather(hashes, -1, order)
    valid = torch.gather(valid, -1, order)
    dup = (
        (times[..., 1:] == times[..., :-1])
        & (hashes[..., 1:] == hashes[..., :-1])
        & valid[..., 1:]
    )
    pad = torch.zeros(dup.shape[:-1] + (1,), dtype=torch.bool, device=dup.device)
    return times, hashes, valid & ~torch.cat([pad, dup], dim=-1)


def compact_valid_first(
    times: torch.Tensor, hashes: torch.Tensor, valid: torch.Tensor, out_len: int = 0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack each row's valid (time, hash) entries to the front, in order,
    into an ``out_len``-wide buffer (default: same width). Valid entries
    past ``out_len`` are dropped; callers detect that via the count.

    Returns (times (B, out_len), hashes (B, out_len), n_valid (B,)); slots
    at or past ``n_valid`` are zero."""
    B, K = times.shape
    out_len = out_len or K
    ranks = torch.cumsum(valid.to(torch.int32), dim=-1)
    # one spare column takes the invalid and overflowing entries
    tgt = torch.where(valid & (ranks <= out_len), ranks - 1, out_len).long()
    t_out = torch.zeros((B, out_len + 1), dtype=times.dtype, device=times.device)
    h_out = torch.zeros((B, out_len + 1), dtype=hashes.dtype, device=hashes.device)
    t_out.scatter_(1, tgt, times)
    h_out.scatter_(1, tgt, hashes)
    return t_out[:, :out_len], h_out[:, :out_len], ranks[:, -1]


def hashes_from_masks_batched(
    masks: torch.Tensor, max_peaks: int, max_hashes: int, window: int = 320
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, F, C) peak masks -> ((B, max_hashes, 2) int32 sorted,
    deduplicated (time, hash) rows, (B, max_hashes) valid);
    ``max_hashes`` must be ``max_peaks * MAXPAIRSPERPEAK``.

    The W-lookahead pairing grid is walked in chunks of 64 offsets with a
    carried per-peak pair count, so live buffers are (B, P, 64)."""
    if max_hashes != max_peaks * MAXPAIRSPERPEAK:
        raise ValueError("max_hashes must be max_peaks * MAXPAIRSPERPEAK")
    B, F, C = masks.shape
    dev = masks.device
    flat = masks.transpose(1, 2).reshape(B, -1)  # column-major
    idx = _first_nonzero(flat, max_peaks)  # (B, P)
    valid = idx >= 0
    safe = torch.where(valid, idx, 0)
    cols = (safe // F).to(torch.int32)
    bins = (safe % F).to(torch.int32)
    P = max_peaks

    Wc = 64
    n_chunks = -(-window // Wc)
    wpad = n_chunks * Wc
    zeros = torch.zeros((B, wpad), dtype=torch.int32, device=dev)
    cols_pad = torch.cat([cols, zeros], dim=1)
    bins_pad = torch.cat([bins, zeros], dim=1)
    valid_pad = torch.cat([valid, zeros.bool()], dim=1)

    def lookahead(xpad: torch.Tensor, start: int) -> torch.Tensor:
        """(B, P + wpad) -> (B, P, Wc) view, [b, i, w] = xpad[b, start + i + w]."""
        return xpad[:, start : start + P + Wc - 1].unfold(1, Wc, 1)

    count = torch.zeros((B, P), dtype=torch.int32, device=dev)
    h_acc = torch.zeros((B, P, MAXPAIRSPERPEAK), dtype=torch.int32, device=dev)
    v_acc = torch.zeros((B, P, MAXPAIRSPERPEAK), dtype=torch.bool, device=dev)
    for base in range(0, wpad, Wc):
        col_j = lookahead(cols_pad, base + 1)
        bin_j = lookahead(bins_pad, base + 1)
        val_j = lookahead(valid_pad, base + 1)
        # offsets beyond `window` in the padded final chunk must not pair
        in_window = base + 1 + torch.arange(Wc, device=dev) <= window
        dt = col_j - cols[:, :, None]
        df = bin_j - bins[:, :, None]
        ok = (
            valid[:, :, None]
            & val_j
            & in_window
            & (dt >= MINDT)
            & (dt < TARGETDT)
            & (df.abs() < TARGETDF)
        )
        rank = count[:, :, None] + torch.cumsum(ok.to(torch.int32), dim=2)
        h = ((bins[:, :, None] & 255) << 12) | ((df & 63) << 6) | (dt & 63)
        for r in range(1, MAXPAIRSPERPEAK + 1):
            hit = ok & (rank == r)
            h_acc[:, :, r - 1] += torch.where(hit, h, 0).sum(dim=2, dtype=torch.int32)
            v_acc[:, :, r - 1] |= hit.any(dim=2)
        count = count + ok.sum(dim=2, dtype=torch.int32)

    hashes = h_acc.reshape(B, -1)  # (B, P*3)
    hvalid = v_acc.reshape(B, -1)
    times = cols[:, :, None].expand(B, P, MAXPAIRSPERPEAK).reshape(B, -1)
    times, hashes, hvalid = sort_dedup_hashes(times, hashes, hvalid)
    return torch.stack([times, hashes], dim=-1), hvalid


def shift_max_peaks(n_cols: int, maxpksperframe: int) -> int:
    """The peak budget of a shift's (B, F, n_cols) masks: ``maxpksperframe``
    a column, rounded up to a multiple of 128."""
    return -(-maxpksperframe * n_cols // 128) * 128


def union_hashes_plain(
    masks_by_shift: Sequence[torch.Tensor], maxpksperframe: int, budget: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (time, hash) union of several shifts' (B, F, C_s) peak masks:
    each shift's hashes (:func:`hashes_from_masks_batched` at
    :func:`shift_max_peaks`), the cross-shift sort and dedup, and the
    compaction to ``out_len = min(budget, sum of the shifts' 3 * P_s)``
    lanes. Returns (times (B, out_len) int32, hashes (B, out_len) int32,
    n_valid (B,) int64), ascending and distinct, zeros past ``n_valid``;
    ``n_valid`` counts every distinct pair, also those past ``out_len``."""
    th_parts, valid_parts = [], []
    for masks in masks_by_shift:
        max_peaks = shift_max_peaks(int(masks.shape[-1]), maxpksperframe)
        th, v = hashes_from_masks_batched(
            masks, max_peaks=max_peaks, max_hashes=max_peaks * MAXPAIRSPERPEAK
        )
        th_parts.append(th)
        valid_parts.append(v)
    th = torch.cat(th_parts, dim=1)
    valid = torch.cat(valid_parts, dim=1)
    t, h, v = sort_dedup_hashes(th[..., 0], th[..., 1], valid)
    return compact_valid_first(t, h, v, out_len=min(budget, t.shape[-1]))


def union_hashes(
    masks_by_shift: Sequence[torch.Tensor], maxpksperframe: int, budget: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`union_hashes_plain`'s result. On CUDA masks it is one launch
    of the hand-written kernel of ``hashes_cuda.py`` (which raises if it
    cannot build or launch, or the masks are not laid out as the prunes
    leave them); on CPU masks it is the plain chain."""
    if masks_by_shift[0].is_cuda:
        from musicfpaugment_torch.afp.audfprint import hashes_cuda

        max_peaks = [shift_max_peaks(int(m.shape[-1]), maxpksperframe) for m in masks_by_shift]
        return hashes_cuda.union_hashes_cuda(masks_by_shift, max_peaks, budget)
    return union_hashes_plain(masks_by_shift, maxpksperframe, budget)


def hashes_from_mask_np(mask: np.ndarray) -> np.ndarray:
    """Host-side exact-size version: (freq, cols) mask -> (N, 2) int32 unique
    sorted (time, hash) pairs; the loop oracle of the batched hasher."""
    F, C = mask.shape
    bins_f, cols_c = np.nonzero(mask)
    order = np.lexsort((bins_f, cols_c))
    cols_s, bins_s = cols_c[order], bins_f[order]
    P = len(cols_s)
    out = []
    for i in range(P):
        pairs = 0
        for j in range(i + 1, P):
            dt = cols_s[j] - cols_s[i]
            if dt >= TARGETDT:
                break
            if dt < MINDT:
                continue
            if abs(int(bins_s[j]) - int(bins_s[i])) < TARGETDF:
                h = (
                    ((int(bins_s[i]) & 255) << 12)
                    | (((int(bins_s[j]) - int(bins_s[i])) & 63) << 6)
                    | (dt & 63)
                )
                out.append((int(cols_s[i]), h))
                pairs += 1
                if pairs >= MAXPAIRSPERPEAK:
                    break
    if not out:
        return np.zeros((0, 2), np.int32)
    arr = np.asarray(out, np.int64)
    packed = (arr[:, 0] << 32) + arr[:, 1]
    uniq = np.unique(packed)
    return np.stack([uniq >> 32, uniq & 0xFFFFFFFF], axis=1).astype(np.int32)

"""Peak-pair landmarks and 20-bit hash packing (port of
musicfpaugment_tpu/afp/audfprint/landmarks.py).

Batched: peaks come out of the (B, F, C) masks in (column, bin) order into a
fixed-size padded array, each peak looks at the next ``window`` peaks, and
the fanout cap ("first ``MAXPAIRSPERPEAK`` valid candidates") is a running
count. Hashes are bit-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

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

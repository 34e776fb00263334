"""Wrapper of the CUDA hashing-stage kernel (csrc/union_hashes.cu).

``union_hashes_cuda`` takes every time shift's (B, F, C_s) bool peak masks
of a query batch as ``peaks.find_peaks_shifts`` returns them on the card
(bool views of the backward prune's time-major (S*B, C, F) uint8 output, so
one query's shift is one contiguous row of C_s * F bytes) and returns, in
one launch (after a copy of its table of shifts, 24 bytes a shift), what ``landmarks.union_hashes_plain`` returns, bit for bit:
(times, hashes, n_valid). It accepts CUDA tensors in that layout only and
raises on anything the kernel does not take; the plain version for CPU
tensors is ``landmarks.union_hashes_plain``, and ``landmarks.union_hashes``
picks between the two. ``LAUNCHES`` counts kernel launches, incremented where
the kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from musicfpaugment_torch import _build
from musicfpaugment_torch.afp.audfprint.landmarks import MAXPAIRSPERPEAK

LAUNCHES: Dict[str, int] = {"union_hashes": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _row_layout(mask: torch.Tensor) -> Tuple[int, int]:
    """(data pointer, bytes from one query to the next) of a (B, F, C) bool
    mask whose queries are time-major (C, F) rows of contiguous bytes."""
    B, F, C = mask.shape
    tm = mask.transpose(1, 2)  # (B, C, F)
    dense = tm.stride(2) == 1 and (C == 1 or tm.stride(1) == F)
    stride = tm.stride(0) if B > 1 else C * F
    if not dense or stride % 16 or mask.data_ptr() % 16:
        raise ValueError(
            "the masks must be time-major (each query's (C, F) bytes contiguous and "
            "16-byte aligned), as the CUDA prunes leave them"
        )
    return mask.data_ptr(), stride


def union_hashes_cuda(
    masks_by_shift: Sequence[torch.Tensor], max_peaks: Sequence[int], budget: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """S (B, F, C_s) bool masks on one CUDA device, each shift's peak budget
    P_s -> (times (B, out_len) int32, hashes (B, out_len) int32, n_valid
    (B,) int64), ``out_len = min(budget, sum of 3 * P_s)``: the ascending,
    distinct union of the shifts' (time, hash) pairs, zeros past
    ``n_valid``, which counts every distinct pair."""
    masks = list(masks_by_shift)
    S = len(masks)
    if not masks or len(max_peaks) != S:
        raise ValueError(
            f"need at least one shift and a peak budget each, got {S} and {len(max_peaks)}"
        )
    m0 = masks[0]
    for m in masks:
        if not m.is_cuda:
            raise ValueError("the CUDA hashing kernel takes CUDA tensors only")
        if m.dtype != torch.bool or m.dim() != 3:
            raise ValueError(f"masks must be 3-D bool, got {m.dtype} {tuple(m.shape)}")
        if m.device != m0.device or m.shape[:2] != m0.shape[:2]:
            raise ValueError("every shift's masks must share the device, batch and bins")
    B, F = int(m0.shape[0]), int(m0.shape[1])
    if budget < 0:
        raise ValueError(f"budget must be non-negative, got {budget}")
    cols = [int(m.shape[2]) for m in masks]
    peaks = [int(p) for p in max_peaks]
    if min(peaks) < 0:
        raise ValueError(f"peak budgets must be non-negative, got {peaks}")
    c_max, peak_total = max(cols), sum(peaks)
    lib = _build.library()
    scratch_bytes = lib.mfpa_union_hashes_scratch_bytes(S, B, F, c_max, peak_total)
    if scratch_bytes < 0:
        raise ValueError(
            f"the kernel takes F a multiple of 16 up to 1024, fewer than 2^22 columns and "
            f"fewer than 2^31 pairs; got F={F}, {c_max} columns, {peak_total} peaks"
        )
    # the kernel's table of shifts: (mask address, bytes a query, C_s | P_s << 32)
    rows = [_row_layout(m) + (c | p << 32,) for m, c, p in zip(masks, cols, peaks)]
    table = (ctypes.c_int64 * (3 * S))(*(v for row in rows for v in row))
    dev = m0.device
    out_len = min(budget, MAXPAIRSPERPEAK * peak_total)
    times = torch.empty((B, out_len), dtype=torch.int32, device=dev)
    hashes = torch.empty((B, out_len), dtype=torch.int32, device=dev)
    n_valid = torch.empty((B,), dtype=torch.int64, device=dev)
    # the table's copy, and each query's workspace where it does not fit
    # shared memory (long inputs)
    scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        status = lib.mfpa_union_hashes(
            ctypes.addressof(table), S, B, F, c_max, peak_total, out_len, scratch.data_ptr(),
            times.data_ptr(), hashes.data_ptr(), n_valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(f"union_hashes kernel launch failed: cudaError {status}")
    LAUNCHES["union_hashes"] += 1
    return times, hashes, n_valid

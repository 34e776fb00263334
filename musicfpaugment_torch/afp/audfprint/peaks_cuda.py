"""Wrappers of the CUDA prune kernels (csrc/peaks_prune.cu), the port of
musicfpaugment_tpu/afp/audfprint/peaks_pallas.py.

The route carries one layout: time-major. ``forward_prune_tm`` and
``backward_prune_tm`` take the (B, C, F) float32 log spectrogram that
``peaks.prune_input(..., time_major=True)`` makes once (one column of a row
is one contiguous read), and return (B, C, F) uint8 masks of 0/1 bytes; the
backward kernel reads the forward kernel's output as it is, and the hashing
reads the result through a bool view without another pass. These two are
what ``peaks.find_peaks_parts`` calls on a CUDA tensor.

``forward_prune_cuda`` / ``backward_prune_cuda`` keep the JAX layout,
(B, F, C) in and out, as thin layers over the same two functions (a
transposed copy in, a transposed bool view out).

All accept CUDA tensors only and raise on anything the kernels do not take;
the plain versions for CPU tensors are ``peaks.forward_prune`` /
``peaks.backward_prune``. ``LAUNCHES`` counts kernel launches per kernel,
incremented where each kernel is launched and nowhere else.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from musicfpaugment_torch import _build
from musicfpaugment_torch.afp.audfprint.peaks import _gauss_table_np

LAUNCHES: Dict[str, int] = {"forward_prune": 0, "backward_prune": 0}
_gauss_cache: Dict[Tuple[int, float, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _gauss_row(F: int, f_sd: float, device: torch.device) -> torch.Tensor:
    """g[d] = exp(-0.5 (d / f_sd)^2) as float32, d = 0..F-1: the first row
    of the plain version's table, so the kernels' bumps are the same IEEE
    products."""
    key = (F, float(f_sd), device.index)
    if key not in _gauss_cache:
        row = _gauss_table_np(F, float(f_sd))[0].copy()
        _gauss_cache[key] = torch.from_numpy(row).to(device)
    return _gauss_cache[key]


def _check_sgram(sgram: torch.Tensor, time_major: bool = False) -> Tuple[int, int, int]:
    """Checks of a (B, F, C) or time-major (B, C, F) spectrogram; returns
    (B, F, C)."""
    if not sgram.is_cuda:
        raise ValueError("the CUDA prune takes CUDA tensors only")
    if sgram.dtype != torch.float32 or sgram.dim() != 3:
        raise ValueError(f"sgram must be 3-D float32, got {sgram.dtype} {tuple(sgram.shape)}")
    B, F, C = sgram.shape
    if time_major:
        F, C = C, F
        if not sgram.is_contiguous() or sgram.data_ptr() % 16:
            raise ValueError("the time-major sgram must be contiguous and 16-byte aligned")
    if F % 32 or F > 512 or B < 1 or C < 1:
        raise ValueError(f"need F % 32 == 0, F <= 512, B, C >= 1; got {(B, F, C)}")
    return B, F, C


def _check_status(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {status}")


def forward_prune_tm(
    tm: torch.Tensor, a_dec: float, f_sd: float = 30.0, maxpks: int = 5
) -> torch.Tensor:
    """Time-major (B, C, F) float32 log spectrogram -> (B, C, F) uint8
    forward peaks (0/1 bytes)."""
    B, F, C = _check_sgram(tm, time_major=True)
    out = torch.empty((B, C, F), dtype=torch.uint8, device=tm.device)
    gauss = _gauss_row(F, f_sd, tm.device)
    stream = torch.cuda.current_stream(tm.device).cuda_stream
    status = _build.library().mfpa_forward_prune(
        tm.data_ptr(), out.data_ptr(), gauss.data_ptr(),
        B, C, F, float(a_dec), int(maxpks), stream,
    )
    _check_status(status, "forward_prune")
    LAUNCHES["forward_prune"] += 1
    return out


def backward_prune_tm(
    tm: torch.Tensor,
    peaks: torch.Tensor,
    a_dec: float,
    f_sd: float = 30.0,
    maxpks: int = 5,
    valid_frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward prune plus the same-bin next-column kill on the time-major
    layout: (B, C, F) float32 and (B, C, F) uint8 forward peaks (0/1 bytes,
    as ``forward_prune_tm`` returns them) -> (B, C, F) uint8.
    ``valid_frames`` (B,) gives each row's real column count: the envelope
    starts at its last valid column and columns past it come back empty."""
    B, F, C = _check_sgram(tm, time_major=True)
    if peaks.shape != tm.shape or peaks.device != tm.device or peaks.dtype != torch.uint8:
        raise ValueError("peaks must be uint8 of sgram's shape on its device")
    if not peaks.is_contiguous() or peaks.data_ptr() % 16:
        raise ValueError("peaks must be contiguous and 16-byte aligned")
    vf_ptr = None
    if valid_frames is not None:
        if valid_frames.shape != (B,) or valid_frames.device != tm.device:
            raise ValueError("valid_frames must be (B,) on sgram's device")
        vf = valid_frames.to(torch.int32).contiguous()
        vf_ptr = vf.data_ptr()
    out = torch.empty((B, C, F), dtype=torch.uint8, device=tm.device)
    gauss = _gauss_row(F, f_sd, tm.device)
    stream = torch.cuda.current_stream(tm.device).cuda_stream
    status = _build.library().mfpa_backward_prune(
        tm.data_ptr(), peaks.data_ptr(), vf_ptr, out.data_ptr(), gauss.data_ptr(),
        B, C, F, float(a_dec), int(maxpks), stream,
    )
    _check_status(status, "backward_prune")
    LAUNCHES["backward_prune"] += 1
    return out


def as_bool_masks(masks_tm: torch.Tensor) -> torch.Tensor:
    """(B, C, F) uint8 0/1 bytes -> the same memory as a (B, F, C) bool
    view: no pass over the data."""
    return masks_tm.view(torch.bool).transpose(1, 2)


def forward_prune_cuda(
    sgram: torch.Tensor, a_dec: float, f_sd: float = 30.0, maxpks: int = 5
) -> torch.Tensor:
    """(B, F, C) float32 log spectrogram -> (B, F, C) bool forward peaks."""
    _check_sgram(sgram)
    tm = sgram.transpose(1, 2).contiguous()
    return as_bool_masks(forward_prune_tm(tm, a_dec, f_sd, maxpks))


def backward_prune_cuda(
    sgram: torch.Tensor,
    peaks: torch.Tensor,
    a_dec: float,
    f_sd: float = 30.0,
    maxpks: int = 5,
    valid_frames: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward prune plus the same-bin next-column kill, (B, F, C) bool in
    and out; ``valid_frames`` as in :func:`backward_prune_tm`."""
    _check_sgram(sgram)
    if peaks.shape != sgram.shape or peaks.device != sgram.device:
        raise ValueError("peaks must match sgram's shape and device")
    tm = sgram.transpose(1, 2).contiguous()
    pm = torch.empty(tm.shape, dtype=torch.uint8, device=tm.device)
    pm.copy_(peaks.transpose(1, 2))  # one transposed bool -> 0/1 byte pass
    return as_bool_masks(backward_prune_tm(tm, pm, a_dec, f_sd, maxpks, valid_frames))

"""Synthetic clean-audio sources (port of
musicfpaugment_tpu/data/synthetic.py).

* :func:`synthetic_clean_batches` — host numpy iterator, identical to the
  JAX package's (same seed, same samples);
* :func:`synth_tracks_device` — the same kind of content built on the
  device, track ``i`` a pure function of ``(seed, i)``: each track draws its
  notes from its own ``torch.Generator``, so a corpus of any size is
  addressable without storage and a track does not depend on the batch it
  is built in. Its bits differ from the JAX version's (different
  generators).
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from musicfpaugment_torch.device import DeviceLike, resolve_device


def synthetic_clean_batches(
    batch_size: int,
    num_samples: int,
    sample_rate: int = 8000,
    seed: int = 59,
) -> Iterator[np.ndarray]:
    """Infinite iterator of (batch, num_samples) float32 clean batches."""
    rng = np.random.default_rng(seed)
    while True:
        batch = np.zeros((batch_size, num_samples), np.float32)
        n_notes = max(4, int(num_samples / sample_rate * 20))
        for b in range(batch_size):
            for _ in range(n_notes):
                f = rng.uniform(80, 3500)
                start = int(rng.integers(0, max(1, num_samples - sample_rate // 8)))
                dur = int(rng.integers(sample_rate // 16, sample_rate // 4))
                end = min(start + dur, num_samples)
                seg = np.arange(end - start)
                env = np.exp(-8.0 * seg / sample_rate).astype(np.float32)
                batch[b, start:end] += (
                    np.sin(2 * np.pi * f * seg / sample_rate).astype(np.float32)
                    * env
                    * rng.uniform(0.3, 1.0)
                )
            peak = np.abs(batch[b]).max()
            if peak > 0:
                batch[b] /= peak
        yield batch


def _track_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    """The generator of track ``index``: seeded from (seed, index) through
    numpy's SeedSequence, so neighbouring indices get unrelated streams."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint32)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def synth_tracks_device(
    seed: int,
    indices: Sequence[int],
    num_samples: int,
    sample_rate: int = 8000,
    notes_per_second: int = 20,
    device: DeviceLike = None,
) -> torch.Tensor:
    """(B,) track indices -> (B, num_samples) float32 tracks on ``device``:
    exponentially decaying sine notes at random onsets, peak-normalized.

    Each note lasts under L = pow2 >= sample_rate/4 + 2 samples, so it is
    evaluated on a 2L-sample window anchored at the L-frame holding its
    onset and added into that frame and the next. The notes anchored in one
    frame are laid out in slots, and the frames are summed slot by slot with
    plain elementwise adds: no atomics, so a track's bits do not depend on
    the batch it is built in."""
    device = resolve_device(device)
    n_notes = max(4, num_samples * notes_per_second // sample_rate)
    B = len(indices)
    params = []
    for idx in indices:
        g = _track_generator(seed, int(idx), device)
        u = torch.rand((4, n_notes), generator=g, device=device)
        params.append(u)
    u = torch.stack(params, dim=1)  # (4, B, n_notes) uniform [0, 1)
    f = 80.0 + u[0] * (3500.0 - 80.0)
    start = u[1] * float(max(1, num_samples - sample_rate // 8))
    dur = sample_rate // 16 + u[2] * float(sample_rate // 4 - sample_rate // 16)
    amp = 0.3 + u[3] * 0.7

    L = 1 << int(np.ceil(np.log2(sample_rate // 4 + 2)))
    n_frames = -(-num_samples // L) + 1  # +1: windows spill one frame right
    anchor = torch.floor(start / L).long()  # (B, N)
    # slot of each note among the notes anchored in its frame (note order)
    order = torch.sort(anchor, dim=1, stable=True).indices
    a_sorted = torch.gather(anchor, 1, order)
    pos = torch.arange(n_notes, device=device).expand(B, n_notes)
    first = torch.where(
        torch.cat([torch.ones_like(a_sorted[:, :1], dtype=torch.bool),
                   a_sorted[:, 1:] != a_sorted[:, :-1]], dim=1),
        pos, 0,
    )
    slot_sorted = pos - torch.cummax(first, dim=1).values
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    n_slots = int(slot.max()) + 1
    note_at = torch.full((B, n_frames, n_slots), -1, dtype=torch.long, device=device)
    note_at[torch.arange(B, device=device)[:, None], anchor, slot] = pos

    j = torch.arange(2 * L, device=device, dtype=torch.float32)
    frame_start = (torch.arange(n_frames, device=device) * L).to(torch.float32)
    acc = torch.zeros((B, n_frames + 1, L), device=device)
    for m in range(n_slots):
        idx = note_at[:, :, m]  # (B, n_frames)
        live = idx >= 0
        safe = torch.clamp(idx, min=0)
        nf, ns, nd, na = (torch.gather(p, 1, safe) for p in (f, start, dur, amp))
        rel = frame_start[None, :, None] - ns[..., None] + j  # (B, frames, 2L)
        gate = live[..., None] & (rel >= 0.0) & (rel < nd[..., None])
        phase = rel / sample_rate
        val = torch.where(
            gate,
            na[..., None] * torch.sin(2.0 * np.pi * nf[..., None] * phase)
            * torch.exp(-8.0 * phase),
            0.0,
        )
        acc[:, :n_frames] += val[..., :L]
        acc[:, 1:] += val[..., L:]
    out = acc[:, :n_frames].reshape(B, n_frames * L)[:, :num_samples]
    peak = torch.amax(out.abs(), dim=-1, keepdim=True)
    return out / torch.clamp(peak, min=1e-9)

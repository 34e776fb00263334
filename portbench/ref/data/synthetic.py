"""Synthetic clean-audio sources (port of
musicfpaugment_tpu/data/synthetic.py).

* :func:`synthetic_clean_batches` — host numpy iterator, identical to the
  JAX package's (same seed, same samples);
* :func:`synth_tracks_device` — the same kind of content built on the
  device, track ``i`` a pure function of ``(seed, i)``: its notes are drawn
  under the threefry key ``fold_in(PRNGKey(seed), i)`` as the JAX
  package's are, so a corpus of any size is addressable without storage, a
  track does not depend on the batch it is built in, and track ``i`` is the
  JAX package's track ``i`` (up to the order of float sums) on every
  device;
* :func:`write_fma_tracks_csv` — a ``tracks.csv`` in FMA's metadata
  layout, for corpora written by tests and smoke runs.
"""

from __future__ import annotations

import csv
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from portbench.ref.core import prng
from portbench.ref.device import DeviceLike, resolve_device


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

    Track ``i`` draws its notes' frequency, onset, length and amplitude from
    ``split(fold_in(PRNGKey(seed), i), 4)``, with the JAX package's bounds.
    Each note lasts under L = pow2 >= sample_rate/4 + 2 samples, so it is
    evaluated on a 2L-sample window anchored at the L-frame holding its
    onset and added into that frame and the next. The notes anchored in one
    frame are laid out in slots, and the frames are summed slot by slot with
    plain elementwise adds: no atomics, so a track's bits do not depend on
    the batch it is built in."""
    device = resolve_device(device)
    n_notes = max(4, num_samples * notes_per_second // sample_rate)
    tids = torch.as_tensor(np.asarray(indices, np.int64))
    B = tids.shape[0]
    # the (B, 4) keys are a few words: derived on the host, one hash of
    # all four parameters' draws on the device
    keys = prng.split(prng.fold_in(prng.key(seed), tids), 4).to(device)
    bounds = torch.tensor([
        [80.0, 0.0, float(sample_rate // 16), 0.3],
        [3500.0, float(max(1, num_samples - sample_rate // 8)), float(sample_rate // 4), 1.0],
    ], device=device)[:, None, :, None]
    f, start, dur, amp = prng.uniform(keys, (n_notes,), bounds[0], bounds[1]).unbind(1)  # (B, n_notes) each

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
    # The JAX package's sin(2 pi f t / sr) exp(-8 t / sr), as XLA rounds it:
    # the division becomes a product with the float32 reciprocal and the
    # constants fold into one factor, rel * (f * (2 pi * (1 / sr))). A
    # note's phase reaches ~5,500 rad, so a rounding of its own would show.
    inv_sr = torch.tensor(1.0 / sample_rate, dtype=torch.float32, device=device)
    omega = torch.tensor(2.0 * np.pi, dtype=torch.float32, device=device) * inv_sr
    decay = inv_sr * -8.0
    frame_start = (torch.arange(n_frames, device=device) * L).to(torch.float32)
    acc = torch.zeros((B, n_frames + 1, L), device=device)
    for m in range(n_slots):
        idx = note_at[:, :, m]  # (B, n_frames)
        live = idx >= 0
        safe = torch.clamp(idx, min=0)
        nf, ns, nd, na = (torch.gather(p, 1, safe) for p in (f, start, dur, amp))
        rel = frame_start[None, :, None] - ns[..., None] + j  # (B, frames, 2L)
        gate = live[..., None] & (rel >= 0.0) & (rel < nd[..., None])
        val = torch.where(
            gate,
            na[..., None] * torch.sin(rel * (nf * omega)[..., None])
            * torch.exp(rel * decay),
            0.0,
        )
        acc[:, :n_frames] += val[..., :L]
        acc[:, 1:] += val[..., L:]
    out = acc[:, :n_frames].reshape(B, n_frames * L)[:, :num_samples]
    peak = torch.amax(out.abs(), dim=-1, keepdim=True)
    return out / torch.clamp(peak, min=1e-9)


FMA_TRACK_COLUMNS = (
    ("album", "title"), ("artist", "name"), ("set", "split"), ("set", "subset"),
    ("track", "duration"), ("track", "genre_top"), ("track", "genres"), ("track", "title"),
)


def write_fma_tracks_csv(
    path: str,
    track_ids: Sequence[int],
    genres: Sequence[Optional[str]],
    durations: Sequence[Optional[float]],
) -> None:
    """FMA's ``fma_metadata/tracks.csv`` layout: a row of column groups, a
    row of column names, a row naming the index (``track_id``), then one row
    a track; a ``None`` genre or duration is an empty cell."""
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, lineterminator="\n")
        w.writerow([""] + [g for g, _ in FMA_TRACK_COLUMNS])
        w.writerow([""] + [n for _, n in FMA_TRACK_COLUMNS])
        w.writerow(["track_id"] + [""] * len(FMA_TRACK_COLUMNS))
        for tid, genre, dur in zip(track_ids, genres, durations):
            w.writerow([
                int(tid), f"Album {tid % 97}, vol. {tid % 7}", f"Artist {tid % 113}",
                "training", "large", "" if dur is None else dur,
                "" if genre is None else genre, f"[{tid % 16}]", f'Track "{tid}"',
            ])

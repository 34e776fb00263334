"""MTG-Jamendo split parsing and data loaders (port of
musicfpaugment_tpu/data/jamendo.py, the reference's training/jamendo.py).

Split semantics are verbatim: autotagging split-0 TSVs; validation = the
first ``val_steps * batch`` seed-4-shuffled validation ids; the remaining
validation ids and the whole test split fold into training.
"""

from __future__ import annotations

import csv
import os
import random
from collections import defaultdict
from typing import Any, DefaultDict, Dict, Tuple

import numpy as np

from musicfpaugment_torch.data.dataset import AugmentationDataset, SegmentPipeline
from musicfpaugment_torch.device import DeviceLike
from musicfpaugment_torch.train.parameters import (
    DURATION,
    N_SEGMENTS,
    TRAIN_BUFFER_SIZE,
    VAL_BUFFER_SIZE,
    VAL_STEPS,
    WAVEFORM_SAMPLING_RATE,
)

JAMENDO_ROOT = os.environ.get("MFPA_JAMENDO_ROOT", "/workspace/mtg-jamendo-dataset/")


TAG_CATEGORIES = ("genre", "instrument", "mood/theme")


def _numeric_id(field: str) -> int:
    """'track_0001234' / 'artist_42' -> the numeric part."""
    return int(field.split("_")[1])


# API-parity alias (the reference names this get_id, jamendo.py:24-26)
get_id = _numeric_id


def get_length(values: Any) -> int:
    """Digits of the widest id (ref: jamendo.py:29-31)."""
    return len(str(max(values)))


def _parse_row(row) -> Tuple[int, Dict[str, Any]]:
    """One autotagging TSV row -> (track_id, metadata dict). The dict keys
    match the reference's consumer contract (jamendo.py:48-74): numeric
    artist/album ids, relative audio path, duration, raw tag strings, and a
    per-category set of tag names."""
    meta: Dict[str, Any] = {
        "artist_id": _numeric_id(row[1]),
        "album_id": _numeric_id(row[2]),
        "path": row[3],
        "duration": float(row[4]),
        "tags": row[5:],
    }
    for category in TAG_CATEGORIES:
        meta[category] = set()
    for tag_str in row[5:]:
        category, tag = tag_str.split("---")
        meta.setdefault(category, set()).update(tag.split(","))
    return _numeric_id(row[0]), meta


def read_file(
    tsv_file: str,
) -> Tuple[Dict[int, Dict[str, Any]], DefaultDict[Any, Dict[Any, Any]], Dict[str, int]]:
    """Parse an MTG-Jamendo autotagging TSV into (tracks, tag index, id-width
    info) — same outputs as the reference's reader (ref: jamendo.py:34-87);
    iteration order of ``tracks`` is TSV row order (split semantics depend on
    it)."""
    tracks: Dict[int, Dict[str, Any]] = {}
    tags: DefaultDict[Any, Dict[Any, Any]] = defaultdict(dict)
    with open(tsv_file) as fp:
        rows = csv.reader(fp, delimiter="\t")
        next(rows, None)  # header
        for row in rows:
            track_id, meta = _parse_row(row)
            tracks[track_id] = meta
            for tag_str in meta["tags"]:
                category, tag = tag_str.split("---")
                tags[category].setdefault(tag, set()).add(track_id)
    artist_ids = {m["artist_id"] for m in tracks.values()}
    album_ids = {m["album_id"] for m in tracks.values()}
    print(
        f"Reading: {len(tracks)} tracks, {len(album_ids)} albums, "
        f"{len(artist_ids)} artists"
    )
    extra = {
        "track_id_length": get_length(tracks.keys()),
        "artist_id_length": get_length(artist_ids),
        "album_id_length": get_length(album_ids),
    }
    return tracks, tags, extra


def get_jamendo_data(
    dataset_path: str, num_val: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Train/val audio-path arrays with the reference's fold-in semantics
    (ref: jamendo.py:90-126): validation = the first ``num_val`` seed-4
    shuffled validation-split ids; the remaining validation ids and the whole
    test split fold into training."""

    def split_paths(name: str) -> Dict[int, str]:
        tracks, _, _ = read_file(
            os.path.join(dataset_path, "data", "splits", "split-0", name)
        )
        audio_root = os.path.join(dataset_path, "raw_30s", "audio")
        return {tid: os.path.join(audio_root, m["path"]) for tid, m in tracks.items()}

    train = split_paths("autotagging-train.tsv")
    val = split_paths("autotagging-validation.tsv")
    test = split_paths("autotagging-test.tsv")

    val_ids = list(val.keys())
    random.Random(4).shuffle(val_ids)
    val_paths = [val[tid] for tid in val_ids[:num_val]]
    train_paths = (
        list(train.values())
        + [val[tid] for tid in val_ids[num_val:]]
        + list(test.values())
    )
    return np.array(train_paths), np.array(val_paths)


def get_data_loaders(
    model_duration_seconds: float = DURATION,
    sampling_frequency: int = WAVEFORM_SAMPLING_RATE,
    val_steps: int = VAL_STEPS,
    mono: bool = True,
    batch_size: int = 8,
    run_val: bool = True,
    dataset_path: str = JAMENDO_ROOT,
    pairs: bool = False,
    device: DeviceLike = None,
):
    """(train, val) iterators (ref: jamendo.py:129-197).

    Default yields CLEAN batches: augmentation happens on the device in the
    train step. ``pairs=True`` gives the reference's (clean, aug) pair
    iterators, augmented in batches on ``device`` (``None`` is CUDA).
    """
    train_ids, val_ids = get_jamendo_data(dataset_path, num_val=val_steps * batch_size)
    print(f"\nNumber of training tracks: {len(train_ids)}")
    print(f"Number of validation tracks: {len(val_ids)}\n")

    if pairs:
        train = iter(
            AugmentationDataset(
                train_ids,
                sampling_frequency=sampling_frequency,
                mono=mono,
                n_segments=N_SEGMENTS,
                model_duration_seconds=model_duration_seconds,
                buffer_size=TRAIN_BUFFER_SIZE,
                noise_split="train",
                batch_size=batch_size,
                device=device,
            )
        )
        val = iter(
            AugmentationDataset(
                val_ids,
                sampling_frequency=sampling_frequency,
                mono=mono,
                n_segments=1,
                model_duration_seconds=model_duration_seconds,
                buffer_size=VAL_BUFFER_SIZE,
                noise_split="val",
                batch_size=batch_size,
                device=device,
            )
        )
        return train, val

    train = iter(
        SegmentPipeline(
            train_ids,
            sampling_frequency,
            duration_s=model_duration_seconds,
            n_segments=N_SEGMENTS,
            batch_size=batch_size,
            buffer_size=TRAIN_BUFFER_SIZE,
        )
    )
    val = iter(
        SegmentPipeline(
            val_ids,
            sampling_frequency,
            duration_s=model_duration_seconds,
            n_segments=1,
            batch_size=batch_size,
            buffer_size=VAL_BUFFER_SIZE,
            seed=4,
        )
    )
    return train, val

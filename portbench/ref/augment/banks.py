"""Device-resident noise and impulse-response banks (port of
musicfpaugment_tpu/augment/banks.py).

Audio is decoded and normalized once on the host; fixed-shape float32
tensors then stay on the device, and "pick a random file" is a gather by a
drawn integer. The builders are numpy and give the same arrays as the JAX
package's for the same inputs and seed.

Sampling is split in two, as everywhere in the port's augmenter: ``draw``
makes the per-example scene/row/offset (or IR index) under a threefry key,
as the JAX bank's ``sample`` does, and ``crop`` / ``take`` do the gathers
for given draws.

* Background noise: a scene is picked uniformly, then a row of that scene,
  then a crop offset; rows shorter than the row length were extended at
  build time by concatenating further RMS-normalized clips. The crop is
  RMS-normalized.
* samplePairing "mixup": two crops are averaged before the final
  normalization.
* IRs: every IR is zero-padded to the bank-wide maximum length, which is
  exact for a linear convolution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from portbench.ref.core import prng
from portbench.ref.core.utils import rms_normalize
from portbench.ref.data.audio_io import (
    Audio,
    find_audio_files_in_paths,
    read_wav,
    resample,
)
from portbench.ref.device import DeviceLike, resolve_device


def draw_shape(key: torch.Tensor, batch: int) -> tuple:
    """The sample shape under ``key``: the whole batch under one key, one
    draw under each key of a (batch, 2) batch of keys."""
    return (batch,) if key.ndim == 1 else (1,)


def _randint(key: torch.Tensor, batch: int, high: int) -> torch.Tensor:
    """(batch,) int32 in [0, high) under ``key``."""
    return prng.randint(key, draw_shape(key, batch), 0, high).reshape(batch)


@dataclass
class NoiseBank:
    """(num_clips, row_length) RMS-normalized noise rows + scene index."""

    clips: torch.Tensor  # (N, L) float32
    scene_starts: torch.Tensor  # (S,) int32, first row of each scene
    scene_counts: torch.Tensor  # (S,) int32, rows per scene
    sample_rate: int

    @property
    def num_clips(self) -> int:
        return self.clips.shape[0]

    @property
    def row_length(self) -> int:
        return self.clips.shape[1]

    @property
    def device(self) -> torch.device:
        return self.clips.device

    def to(self, device: DeviceLike) -> "NoiseBank":
        return NoiseBank(
            self.clips.to(device),
            self.scene_starts.to(device),
            self.scene_counts.to(device),
            self.sample_rate,
        )

    def draw(self, key: torch.Tensor, batch: int, num_samples: int) -> Dict[str, torch.Tensor]:
        """Scene-uniform scene, row uniform and crop offset of ``batch``
        crops under ``key``: three keys split from it, as the JAX bank's
        ``sample`` draws them (no offset draw for a crop as long as the
        row)."""
        key = prng.as_key(key)
        k_scene, k_row, k_off = prng.split(key, 3).unbind(-2)
        max_off = self.row_length - num_samples
        return {
            "scene": _randint(k_scene, batch, self.scene_starts.shape[0]),
            "row_u": prng.uniform(k_row, draw_shape(key, batch)).reshape(batch),
            "offset": (
                _randint(k_off, batch, max_off + 1) if max_off > 0
                else torch.zeros((batch,), dtype=torch.int32)
            ),
        }

    def crop(
        self,
        scene: torch.Tensor,
        row_u: torch.Tensor,
        offset: torch.Tensor,
        num_samples: int,
    ) -> torch.Tensor:
        """(B, num_samples) RMS-normalized crops: row
        ``scene_starts[scene] + int(row_u * scene_counts[scene])`` from
        ``offset``. A crop as long as the row, or longer, is the whole row."""
        dev = self.device
        scene = scene.to(dev, torch.int64)
        row = self.scene_starts[scene].to(torch.int64) + (
            row_u.to(dev, torch.float32) * self.scene_counts[scene].to(torch.float32)
        ).to(torch.int64)
        if self.row_length - num_samples <= 0:
            return rms_normalize(self.clips[row])
        cols = offset.to(dev, torch.int64)[:, None] + torch.arange(num_samples, device=dev)
        return rms_normalize(self.clips[row[:, None], cols])

    def crop_pair(self, first: dict, second: dict, num_samples: int) -> torch.Tensor:
        """samplePairing mixup: the average of two crops, RMS-normalized."""
        a = self.crop(first["scene"], first["row_u"], first["offset"], num_samples)
        b = self.crop(second["scene"], second["row_u"], second["offset"], num_samples)
        return rms_normalize((a + b) / 2.0)

    def sample(self, key: torch.Tensor, batch_size: int, num_samples: int) -> torch.Tensor:
        """Draw (batch_size, num_samples) noise crops, scene-uniform."""
        return self.crop(**self.draw(key, batch_size, num_samples), num_samples=num_samples)

    def sample_pair(self, key: torch.Tensor, batch_size: int, num_samples: int) -> torch.Tensor:
        """Draw mixup crops: the average of two independent draws."""
        k1, k2 = prng.split(prng.as_key(key)).unbind(-2)
        return self.crop_pair(
            self.draw(k1, batch_size, num_samples), self.draw(k2, batch_size, num_samples),
            num_samples,
        )


@dataclass
class IRBank:
    """(num_irs, max_ir_length) zero-padded mono impulse responses."""

    irs: torch.Tensor  # (N, L) float32
    lengths: torch.Tensor  # (N,) int32 true lengths
    sample_rate: int

    @property
    def num_irs(self) -> int:
        return self.irs.shape[0]

    @property
    def device(self) -> torch.device:
        return self.irs.device

    def to(self, device: DeviceLike) -> "IRBank":
        return IRBank(self.irs.to(device), self.lengths.to(device), self.sample_rate)

    def draw(self, key: torch.Tensor, batch: int) -> torch.Tensor:
        """(batch,) int32 IR indices under ``key``."""
        return _randint(prng.as_key(key), batch, self.num_irs)

    def take(self, index: torch.Tensor) -> torch.Tensor:
        """(B,) indices -> (B, L) impulse responses."""
        return self.irs[index.to(self.device, torch.int64)]

    def sample(self, key: torch.Tensor, batch_size: int) -> torch.Tensor:
        return self.take(self.draw(key, batch_size))


# ------------------------------------------------------------------ builders


def _extend_row(
    clip: np.ndarray, pool: List[np.ndarray], row_length: int, rng: np.random.Generator
) -> np.ndarray:
    """RMS-normalize and extend a clip to row_length by concatenating further
    RMS-normalized random clips."""
    pieces = [clip / (np.sqrt(np.mean(clip**2)) + 1e-8)]
    total = clip.shape[0]
    while total < row_length:
        extra = pool[int(rng.integers(len(pool)))]
        pieces.append(extra / (np.sqrt(np.mean(extra**2)) + 1e-8))
        total += extra.shape[0]
    row = np.concatenate(pieces)[:row_length]
    return row.astype(np.float32)


def build_noise_bank(
    background_paths: Union[Dict[str, List[str]], Sequence[str], np.ndarray],
    sample_rate: int,
    row_length: int = 8 * 8000,
    seed: int = 0,
    max_clips_per_scene: int | None = None,
    device: DeviceLike = None,
) -> NoiseBank:
    """Build a NoiseBank from a ``{scene: [paths]}`` dict, a flat path list,
    or a pre-decoded (N, T) array. The bank is built on the host and put on
    ``device`` (``None`` is CUDA)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    if isinstance(background_paths, np.ndarray):
        arrays = [background_paths[i] for i in range(background_paths.shape[0])]
        scenes = {"synthetic": arrays}
    elif isinstance(background_paths, dict):
        # values may be file paths or pre-decoded arrays
        scenes = {}
        for scene, paths in background_paths.items():
            if max_clips_per_scene is not None:
                paths = list(paths)[:max_clips_per_scene]
            scenes[scene] = [
                np.asarray(p, np.float32)
                if isinstance(p, np.ndarray)
                else _load_mono(p, sample_rate)
                for p in paths
            ]
    else:
        scenes = {"all": [_load_mono(p, sample_rate) for p in background_paths]}

    pool = [c for clips in scenes.values() for c in clips]
    rows, starts, counts = [], [], []
    for scene in sorted(scenes):
        starts.append(len(rows))
        for clip in scenes[scene]:
            rows.append(_extend_row(clip, pool, row_length, rng))
        counts.append(len(rows) - starts[-1])
    if not rows:
        raise ValueError("There are no supported audio files found.")
    return NoiseBank(
        clips=torch.from_numpy(np.stack(rows)).to(device),
        scene_starts=torch.from_numpy(np.asarray(starts, np.int32)).to(device),
        scene_counts=torch.from_numpy(np.asarray(counts, np.int32)).to(device),
        sample_rate=sample_rate,
    )


def build_ir_bank(
    ir_paths: Union[str, Sequence[str], np.ndarray],
    sample_rate: int,
    max_length: int | None = None,
    device: DeviceLike = None,
) -> IRBank:
    """Build an IRBank from a directory, path list, or (N, T) array, on
    ``device`` (``None`` is CUDA)."""
    device = resolve_device(device)
    if isinstance(ir_paths, np.ndarray):
        irs = [ir_paths[i] for i in range(ir_paths.shape[0])]
    else:
        if isinstance(ir_paths, str):
            ir_paths = [ir_paths]
        files = find_audio_files_in_paths(ir_paths)
        if len(files) == 0:
            raise ValueError("There are no supported audio files found.")
        irs = [_load_mono(p, sample_rate) for p in files]
    lengths = np.asarray([ir.shape[0] for ir in irs], np.int32)
    pad_to = int(max_length or lengths.max())
    padded = np.zeros((len(irs), pad_to), np.float32)
    for i, ir in enumerate(irs):
        n = min(ir.shape[0], pad_to)
        padded[i, :n] = ir[:n]
    return IRBank(
        irs=torch.from_numpy(padded).to(device),
        lengths=torch.from_numpy(np.minimum(lengths, pad_to)).to(device),
        sample_rate=sample_rate,
    )


def _load_mono(path: Union[str, Tuple[str, str]], sample_rate: int) -> np.ndarray:
    """Decode to mono float32 at sample_rate. A 2-tuple denotes a mixup pair
    (averaged at build time)."""
    if isinstance(path, (tuple, list)) and len(path) == 2 and not isinstance(path, str):
        a = _load_mono(path[0], sample_rate)
        b = _load_mono(path[1], sample_rate)
        n = min(a.shape[0], b.shape[0])
        return (a[:n] + b[:n]) / 2.0
    data, sr = read_wav(path)
    mono = data.mean(axis=0) if data.shape[0] > 1 else data[0]
    return resample(mono, sr, sample_rate)


__all__ = [
    "NoiseBank",
    "IRBank",
    "build_noise_bank",
    "build_ir_bank",
    "Audio",
]

"""Training input pipeline: host decode and segment, device augment (port
of musicfpaugment_tpu/data/dataset.py, numpy on the port's
``data/audio_io.py``).

* host (this module): decode -> resample -> peak-norm -> 3 s segmentation ->
  silence filter -> shuffle buffer -> fixed-shape CLEAN batches, on worker
  threads with bounded queues;
* device (train step): ``AugmentFP`` degrades the clean batch inside the
  training step (musicfpaugment_torch.train.trainer).

``AugmentationDataset`` keeps the reference's (clean, aug) pair-iterator API;
pair mode augments whole batches on the augmenter's device.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from musicfpaugment_torch.data.audio_io import read_wav, resample
from musicfpaugment_torch.device import DeviceLike


def load_track(
    path: str,
    sample_rate: int,
    mono: bool = True,
    do_norm: bool = True,
    max_dur_in_minutes: float = 10.0,
) -> np.ndarray:
    """Decode + resample + peak-normalize one track
    (ref: training/dataset.py:20-65; corrupt files yield silence like the
    reference's zero-fill except branch)."""
    try:
        data, sr = read_wav(path)
    except Exception:
        return np.zeros(int(max_dur_in_minutes * 60 * sample_rate), np.float32)
    max_n = int(max_dur_in_minutes * 60 * sr)
    data = data[:, :max_n]
    audio = data.mean(axis=0) if (mono and data.shape[0] > 1) else data[0]
    audio = resample(audio, sr, sample_rate)
    if do_norm:
        peak = np.abs(audio).max()
        if peak != 0:
            audio = audio / peak
    return audio.astype(np.float32)


def segment_track(
    audio: np.ndarray, duration_s: float, sample_rate: int, step_fraction: float = 1.0
) -> np.ndarray:
    """Frame into fixed windows (ref: chunk_audio, dataset.py:68-83)."""
    frame_len = int(duration_s * sample_rate)
    step = int(duration_s * step_fraction * sample_rate)
    if audio.shape[0] < frame_len:
        return np.zeros((0, frame_len), np.float32)
    n = 1 + (audio.shape[0] - frame_len) // step
    idx = np.arange(n)[:, None] * step + np.arange(frame_len)[None, :]
    return audio[idx]


def select_no_silence_frames(
    audio: np.ndarray, segments: np.ndarray, dbs_threshold: float = -7.5
) -> np.ndarray:
    """Drop near-silent segments (ref: dataset.py:86-107). Note the
    reference's 'dBs' use the natural log (tf.math.log), preserved here."""
    if segments.shape[0] == 0:
        return segments
    rms_ref = np.sqrt(np.mean(audio**2))
    rms_seg = np.sqrt(np.mean(segments**2, axis=-1))
    with np.errstate(divide="ignore"):
        dbs = 10.0 * np.log(rms_seg / max(rms_ref, 1e-12))
    return segments[dbs > dbs_threshold]


class SegmentPipeline:
    """Threaded decode/segment pipeline yielding (batch, T) clean batches.

    Equivalent role to the reference's tf.data graph (dataset.py:212-239):
    shuffled path order, per-track segmentation + silence filter + per-track
    take(n_segments), a global shuffle buffer, infinite repeat.
    """

    def __init__(
        self,
        paths: Sequence[str],
        sample_rate: int,
        duration_s: float = 3.0,
        n_segments: int = 5,
        batch_size: int = 128,
        buffer_size: int = 8192,
        num_workers: int = 4,
        seed: int = 59,
        mono: bool = True,
        do_norm: bool = True,
    ) -> None:
        self.paths = list(paths)
        self.sample_rate = sample_rate
        self.duration_s = duration_s
        self.n_segments = n_segments
        self.batch_size = batch_size
        self.buffer_size = buffer_size
        self.num_workers = num_workers
        self.mono = mono
        self.do_norm = do_norm
        self._rng = random.Random(seed)
        self._nprng = np.random.default_rng(seed)
        self._segment_q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=buffer_size)
        self._path_q: "queue.Queue[str]" = queue.Queue(maxsize=64)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # --------------------------------------------------------- workers

    def _feeder(self) -> None:
        while not self._stop.is_set():
            order = list(self.paths)
            self._rng.shuffle(order)
            for p in order:
                if self._stop.is_set():
                    return
                self._path_q.put(p)

    def _worker(self, wid: int) -> None:
        rng = np.random.default_rng(hash((wid, id(self))) % (2**32))
        while not self._stop.is_set():
            try:
                path = self._path_q.get(timeout=0.5)
            except queue.Empty:
                continue
            audio = load_track(path, self.sample_rate, self.mono, self.do_norm)
            segments = segment_track(audio, self.duration_s, self.sample_rate)
            segments = select_no_silence_frames(audio, segments)
            if segments.shape[0] == 0:
                continue
            take = rng.permutation(segments.shape[0])[: self.n_segments]
            for s in segments[take]:
                if self._stop.is_set():
                    return
                self._segment_q.put(s)

    def start(self) -> "SegmentPipeline":
        if self._threads:
            return self
        t = threading.Thread(target=self._feeder, daemon=True)
        t.start()
        self._threads.append(t)
        for w in range(self.num_workers):
            t = threading.Thread(target=self._worker, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        # drain so blocked workers can exit
        try:
            while True:
                self._segment_q.get_nowait()
        except queue.Empty:
            pass

    # --------------------------------------------------------- iteration

    def __iter__(self) -> Iterator[np.ndarray]:
        self.start()
        shuffle_buf: List[np.ndarray] = []
        while True:
            while len(shuffle_buf) < max(self.batch_size, self.buffer_size // 4):
                shuffle_buf.append(self._segment_q.get())
            idx = self._nprng.permutation(len(shuffle_buf))[: self.batch_size]
            batch = np.stack([shuffle_buf[i] for i in idx])
            for i in sorted(idx, reverse=True):
                shuffle_buf.pop(i)
            yield batch

    def __next__(self):
        if not hasattr(self, "_iter"):
            self._iter = iter(self)
        return next(self._iter)


class AugmentationDataset:
    """(clean, aug) pair iterator, the reference's ``AugmentationDataset``
    API, with batched augmentation on the augmenter's device. Without an
    ``augmenter`` one is built from the DCASE split ``noise_split`` on
    ``device`` (``None`` is CUDA). Both halves are numpy arrays.
    """

    def __init__(
        self,
        paths: Sequence[str],
        sampling_frequency: int,
        mono: bool = True,
        n_segments: int = 1,
        model_duration_seconds: float = 3.0,
        do_norm: bool = True,
        buffer_size: int = 32,
        noise_split: str = "train",
        augmenter: Optional[Any] = None,
        batch_size: int = 128,
        num_workers: int = 4,
        seed: int = 59,
        device: DeviceLike = None,
    ) -> None:
        if augmenter is None:
            from musicfpaugment_torch.augment import AugmentFP
            from musicfpaugment_torch.data.dcase import load_noise_split

            augmenter = AugmentFP(
                load_noise_split(noise_split), sampling_frequency, device=device
            )
        self.augmenter = augmenter
        self.pipeline = SegmentPipeline(
            paths,
            sampling_frequency,
            duration_s=model_duration_seconds,
            n_segments=n_segments,
            batch_size=batch_size,
            buffer_size=max(buffer_size, batch_size),
            num_workers=num_workers,
            seed=seed,
            mono=mono,
            do_norm=do_norm,
        )

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for clean in self.pipeline:
            aug = self.augmenter.batch_augment(clean[:, None, :])[:, 0, :].cpu().numpy()
            yield clean, aug

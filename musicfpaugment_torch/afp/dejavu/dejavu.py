"""Dejavu orchestrator (port of musicfpaugment_tpu/afp/dejavu/dejavu.py).

Audio is read on the host (wav, pkl, npy or an array), fingerprinted on the
device (one file at a time, or a batch in one pass with
:meth:`Dejavu.fingerprint_arrays` / :meth:`Dejavu.fingerprint_batch`),
hashed with SHA1 on the host and stored in a SQL backend (SQLite by
default, Postgres on request). :meth:`Dejavu.align_matches`, the
offset-histogram consensus, is the oracle of the device matcher.
Denoisers are injected: the UNet as a spectrogram hook, Demucs or HTDemucs
as a waveform hook (``afp/denoising.py`` names the kinds).
"""

from __future__ import annotations

import os
import pickle
from hashlib import sha1
from itertools import groupby
from time import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from musicfpaugment_torch.afp.dejavu.fingerprint import (
    DEFAULT_SETTINGS,
    fingerprint,
    fingerprint_spectrogram_batch,
    generate_hashes,
    peaks_from_mask,
)
from musicfpaugment_torch.afp.dejavu.sqlite_database import SQLiteDatabase
from musicfpaugment_torch.afp.dejavu.variables import (
    FINGERPRINTED_CONFIDENCE,
    FINGERPRINTED_HASHES,
    HASHES_MATCHED,
    INPUT_CONFIDENCE,
    INPUT_CONFIDENCE_2,
    INPUT_HASHES,
    OFFSET,
    OFFSET_SECS,
    SONG_ID,
    SONG_NAME,
    TOPN,
)
from musicfpaugment_torch.afp.denoising import (
    DEJAVU_ORDER,
    SPECTROGRAM_DENOISERS,
    WAVEFORM_DENOISERS,
    check_denoising_model,
)
from musicfpaugment_torch.data.audio_io import read_wav, resample
from musicfpaugment_torch.device import DeviceLike, resolve_device


def unique_hash(file_path: str, block_size: int = 2**20) -> str:
    """Upper-case SHA1 of a file's contents."""
    s = sha1()
    with open(file_path, "rb") as f:
        while True:
            buf = f.read(block_size)
            if not buf:
                break
            s.update(buf)
    return s.hexdigest().upper()


def read(
    filename: Union[str, np.ndarray],
    denoising: bool = False,
    denoising_model: str = "unet",
    wave_denoiser: Optional[Callable] = None,
    sample_rate: int = 8000,
    int16_scale: bool = True,
    device: DeviceLike = None,
) -> Tuple[List[np.ndarray], int, str]:
    """Audio as int16-scaled channels: a pkl, npy or wav file or an array ->
    mono at ``sample_rate``, times 32767, with waveform denoising first when
    ``denoising_model`` is a waveform kind (``denoising.WAVEFORM_DENOISERS``).
    Returns (channels, sample rate, upper-case content SHA1).

    The waveform hook gets a (1, T) tensor on ``device`` (its model's) and
    its result comes back as numpy. ``int16_scale=False`` returns the raw
    float waveform, so that batched callers can scale after a batched
    denoise and stay bit-identical to this per-file path."""
    if denoising:
        check_denoising_model(denoising_model, DEJAVU_ORDER)
    if isinstance(filename, np.ndarray):
        audio = filename.astype(np.float32).reshape(-1)
        file_hash = sha1(audio.tobytes()).hexdigest().upper()
        native_sr = sample_rate
    else:
        ext = str(filename).split(".")[-1]
        if ext == "pkl":
            with open(filename, "rb") as f:
                audio = np.asarray(pickle.load(f), np.float32).reshape(-1)
            native_sr = sample_rate
        elif ext == "npy":
            audio = np.load(filename).astype(np.float32).reshape(-1)
            native_sr = sample_rate
        else:
            data, native_sr = read_wav(filename)
            audio = data.mean(axis=0) if data.shape[0] > 1 else data[0]
        file_hash = unique_hash(str(filename))

    if denoising is True and denoising_model in WAVEFORM_DENOISERS:
        if wave_denoiser is None:
            raise ValueError(f"{denoising_model} denoising requires wave_denoiser")
        x = torch.from_numpy(np.ascontiguousarray(audio[None, :])).to(resolve_device(device))
        audio = wave_denoiser(x).detach().to("cpu", torch.float32).numpy()[0]

    audio = resample(audio, native_sr, sample_rate)
    channels = [audio * 32767.0 if int16_scale else audio]
    return channels, sample_rate, file_hash


class Dejavu:
    """Fingerprint store and recognizer over a SQL backend.

    ``config["database_type"] == "postgres"`` selects
    :class:`PostgreSQLDatabase` (imported only then) with
    ``config["database"]`` as its connection options; otherwise SQLite.
    ``db`` passes a backend directly. Spectrograms and peaks run on
    ``device``."""

    def __init__(
        self,
        config: Dict[str, Any],
        settings: Optional[Dict[str, Any]] = None,
        state: str = "set",
        denoising: bool = False,
        denoising_model: Optional[str] = None,
        spec_denoiser: Optional[Callable] = None,
        wave_denoiser: Optional[Callable] = None,
        db=None,
        device: DeviceLike = None,
    ):
        self.config = config
        self.settings = dict(settings or DEFAULT_SETTINGS)
        self.device = resolve_device(device)
        if db is not None:
            self.db = db
        else:
            db_cfg = dict(config.get("database", {}))
            if config.get("database_type", "sqlite") == "postgres":
                from musicfpaugment_torch.afp.dejavu.postgres_database import (
                    PostgreSQLDatabase,
                )

                self.db = PostgreSQLDatabase(**db_cfg)
            else:
                self.db = SQLiteDatabase(**db_cfg)
        if denoising:
            check_denoising_model(denoising_model, DEJAVU_ORDER)
        self.denoising = denoising
        self.denoising_model = denoising_model
        self.spec_denoiser = spec_denoiser
        self.wave_denoiser = wave_denoiser

        if state == "set":
            self.db.setup()
        elif state == "clear":
            self.db.empty()
        self.__load_fingerprinted_audio_hashes()

    def __load_fingerprinted_audio_hashes(self) -> None:
        self.songs = self.db.get_songs()
        self.songhashes_set = set()
        for song in self.songs:
            self.songhashes_set.add(song["file_sha1"])

    def _spec_hook(self) -> Optional[Callable]:
        if self.denoising and self.denoising_model in SPECTROGRAM_DENOISERS:
            return self.spec_denoiser
        return None

    def _fp_kwargs(self) -> Dict[str, Any]:
        st = self.settings
        return dict(
            Fs=st["samplerate"], wsize=st["n_fft"], n_hop=st["n_hop"],
            fan_value=st["fan_value"], amp_min=st["amp_min"], device=self.device,
        )

    # ------------------------------------------------------------ ingest

    def fingerprint_directory(self, path_list: list, nprocesses=None) -> None:
        """Fingerprint and store each file in turn, skipping files whose
        content hash is already stored. A file that cannot be read prints
        and is skipped, as the original Dejavu's pool skips a failed worker
        (the JAX package raises)."""
        for file_name in path_list:
            if (
                isinstance(file_name, str)
                and os.path.exists(file_name)
                and unique_hash(file_name) in self.songhashes_set
            ):
                continue
            try:
                song_name, hashes, file_hash = self._fingerprint_worker((file_name, None))
            except (OSError, ValueError) as exc:
                print("Failed fingerprinting", file_name, exc)
                continue
            sid = self.db.insert_song(song_name, file_hash, len(hashes))
            self.db.insert_hashes(sid, list(hashes))
            self.db.set_song_fingerprinted(sid)
            self.__load_fingerprinted_audio_hashes()

    def _fingerprint_worker(self, arguments):
        file_name, _limit = arguments
        song_name, _ext = os.path.splitext(os.path.basename(str(file_name)))
        fingerprints, file_hash = self.get_file_fingerprints(file_name)
        return song_name, fingerprints, file_hash

    def get_file_fingerprints(self, file_name: str):
        """The set of one file's hashes, and its content hash."""
        channels, _fs, file_hash = read(
            file_name, sample_rate=self.settings["samplerate"]
        )
        fingerprints = set()
        for channel in channels:
            fingerprints |= set(fingerprint(channel, **self._fp_kwargs()))
        return fingerprints, file_hash

    def fingerprint_arrays(
        self, names: List[str], waveforms, sample_rate: int = 8000
    ) -> None:
        """Batched ingest: the peak masks of a (B, T) batch in one pass on the
        device (x 32767, as :func:`read` scales), hashing and inserts on the
        host. Each song's content hash is the SHA1 of its float32 samples."""
        wavs = torch.as_tensor(waveforms, dtype=torch.float32, device=self.device)
        st = self.settings
        _, masks, _ = fingerprint_spectrogram_batch(
            wavs * 32767.0, st["samplerate"], st["n_fft"], st["n_hop"], st["amp_min"]
        )
        masks = masks.cpu().numpy()
        host = wavs.cpu().numpy()
        for name, mask, wav in zip(names, masks, host):
            hashes = set(generate_hashes(peaks_from_mask(mask), fan_value=st["fan_value"]))
            file_hash = sha1(wav.tobytes()).hexdigest().upper()
            sid = self.db.insert_song(name, file_hash, len(hashes))
            self.db.insert_hashes(sid, list(hashes))
            self.db.set_song_fingerprinted(sid)
        self.__load_fingerprinted_audio_hashes()

    # ------------------------------------------------------------ query

    def fingerprint_batch(
        self, waveforms, scaled: bool = False
    ) -> List[List[Tuple[str, int]]]:
        """Batched query fingerprints: spectrograms and peaks of the whole
        (B, T) batch in one pass on the device, SHA1 hashing on the host.
        ``scaled`` marks inputs already int16-scaled (``read()`` output)."""
        wavs = torch.as_tensor(waveforms, dtype=torch.float32, device=self.device)
        if not scaled:
            wavs = wavs * 32767.0
        st = self.settings
        _, masks, _ = fingerprint_spectrogram_batch(
            wavs, st["samplerate"], st["n_fft"], st["n_hop"], st["amp_min"],
            denoiser=self._spec_hook(),
        )
        return [
            generate_hashes(peaks_from_mask(m), fan_value=st["fan_value"])
            for m in masks.cpu().numpy()
        ]

    def generate_fingerprints(
        self, samples, get_masks: bool = False
    ) -> Tuple[List[Tuple[str, int]], float]:
        """(hashes, seconds) of one channel; with ``get_masks=True``
        ``samples`` is a file or an array that goes through :func:`read`
        (waveform denoising included) and the result is (peak mask,
        spectrogram)."""
        t = time()
        model = self.denoising_model or "unet"
        kw = dict(self._fp_kwargs(), denoising=self.denoising, denoising_model=model,
                  denoiser=self._spec_hook())
        if get_masks is True:
            channels, _, _ = read(
                samples,
                denoising=self.denoising,
                denoising_model=model,
                wave_denoiser=self.wave_denoiser,
                sample_rate=self.settings["samplerate"],
                device=self.device,
            )
            _hashes, peak_mask, specgram = fingerprint(channels[0], get_masks=True, **kw)
            return peak_mask, specgram
        result = fingerprint(samples, get_masks=False, **kw)
        return result, time() - t

    def find_matches(self, hashes) -> Tuple[List[Tuple[int, int]], Dict[int, int], float]:
        """(matches, per-song dedup counts, seconds) from the database."""
        t = time()
        matches, dedup_hashes = self.db.return_matches(list(hashes))
        return matches, dedup_hashes, time() - t

    def align_matches(
        self,
        matches: List[Tuple[int, int]],
        dedup_hashes: Dict[int, int],
        queried_hashes: int,
        topn: int = TOPN,
    ) -> List[Dict[str, Any]]:
        """Offset-histogram consensus: per song its most frequent offset
        difference, songs ranked by that count (ties to the lower song id,
        then the lower offset). ``input_confidence_2`` and
        ``nb_matches_with_offset`` take the top song's count, as the
        original Dejavu does."""
        sorted_matches = sorted(matches, key=lambda m: (m[0], m[1]))
        counts = [
            (*key, len(list(group)))
            for key, group in groupby(sorted_matches, key=lambda m: (m[0], m[1]))
        ]
        songs_matches = sorted(
            [
                max(list(group), key=lambda g: g[2])
                for _key, group in groupby(counts, key=lambda count: count[0])
            ],
            key=lambda count: count[2],
            reverse=True,
        )

        songs_result = []
        for song_id, offset, _ in songs_matches[0:topn]:
            song = self.db.get_song_by_id(song_id)
            song_name = song.get(SONG_NAME, None)
            song_hashes = song.get("total_hashes", None)
            nseconds = round(
                float(offset) / self.settings["samplerate"] * self.settings["n_hop"],
                5,
            )
            hashes_matched = dedup_hashes[song_id]
            songs_result.append(
                {
                    SONG_ID: song_id,
                    SONG_NAME: song_name.encode("utf8") if song_name else song_name,
                    INPUT_HASHES: queried_hashes,
                    FINGERPRINTED_HASHES: song_hashes,
                    HASHES_MATCHED: hashes_matched,
                    INPUT_CONFIDENCE: round(hashes_matched / queried_hashes, 2),
                    INPUT_CONFIDENCE_2: round(
                        songs_matches[0][2] / queried_hashes, 2
                    ),
                    "nb_matches_with_offset": songs_matches[0][2],
                    FINGERPRINTED_CONFIDENCE: round(
                        hashes_matched / song_hashes, 2
                    ),
                    OFFSET: offset,
                    OFFSET_SECS: nseconds,
                    "file_sha1": (song.get("file_sha1") or "").encode("utf8"),
                }
            )
        return songs_result

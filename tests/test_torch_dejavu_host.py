"""The Dejavu host layer of the port: ``read``, the SQLite store, ``Dejavu``
and ``FileRecognizer``, against the JAX package on the CPU.

``read`` returns bit-identical samples and content hashes for wav, npy, pkl
and array inputs, and hands a Demucs hook a (1, T) tensor on the given
device. The SQLite store round-trips as the JAX one does. ``Dejavu`` indexes
the same corpus into the same rows, and its verdicts (every field but the
timings) equal JAX's.
"""

import os
import pickle

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from musicfpaugment_torch.afp.dejavu import (
    Dejavu,
    FileRecognizer,
    SQLiteDatabase,
    fingerprint,
    read,
    unique_hash,
)
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_tpu.afp import dejavu as JD
from musicfpaugment_tpu.afp.dejavu.sqlite_database import SQLiteDatabase as JSQLiteDatabase

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
TIMINGS = ("total_time", "fingerprint_time", "query_time", "align_time")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four 6 s tracks as 16-bit wav files (one of them stereo at 16 kHz),
    and 2 s crops as npy and pkl files."""
    root = tmp_path_factory.mktemp("dejavu_host")
    tracks = next(synthetic_clean_batches(4, 6 * SR, seed=71, sample_rate=SR))
    paths = []
    for i, x in enumerate(tracks):
        p = str(root / f"track_{i}.wav")
        if i == 3:
            up = np.repeat(x, 2)
            scipy.io.wavfile.write(p, 2 * SR, (np.stack([up, 0.5 * up], 1) * 32000).astype(np.int16))
        else:
            scipy.io.wavfile.write(p, SR, (x * 32000).astype(np.int16))
        paths.append(p)
    crops = []
    for i, x in enumerate(tracks[:3]):
        crop = x[SR : 3 * SR].astype(np.float32)
        np.save(root / f"track_{i}.npy", crop)
        with open(root / f"track_{i}.pkl", "wb") as f:
            pickle.dump(crop, f)
        crops.append(crop)
    return root, tracks, paths, crops


def test_read_matches_jax(files):
    root, _, paths, crops = files
    sources = paths + [str(root / "track_0.npy"), str(root / "track_1.pkl"), crops[2]]
    for src in sources:
        for scale in (True, False):
            (got,), sr, h = read(src, int16_scale=scale)
            (want,), j_sr, j_h = JD.read(src, int16_scale=scale)
            assert sr == j_sr == SR and h == j_h
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert unique_hash(paths[0]) == JD.unique_hash(paths[0])


def test_read_hands_demucs_a_row_tensor(files):
    root, _, paths, crops = files
    seen = []

    def hook(w):
        seen.append((type(w), tuple(w.shape), w.device.type, w.dtype))
        return 0.5 * w

    for src in (paths[1], str(root / "track_2.npy"), crops[0]):
        (got,), _, _ = read(src, denoising=True, denoising_model="demucs", wave_denoiser=hook,
                            device="cpu")
        (want,), _, _ = JD.read(src, denoising=True, denoising_model="demucs",
                                wave_denoiser=lambda w: 0.5 * np.asarray(w))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert [s[0] for s in seen] == [torch.Tensor] * 3
    assert all(s[1][0] == 1 and s[2] == "cpu" and s[3] == torch.float32 for s in seen)
    with pytest.raises(ValueError, match="wave_denoiser"):
        read(crops[0], denoising=True, denoising_model="demucs", device="cpu")
    with pytest.raises(ValueError, match="'unet' or 'demucs'"):
        read(crops[0], denoising=True, denoising_model="wiener")
    # the UNet arm leaves the waveform as it is
    (plain,), _, _ = read(crops[0])
    (unet,), _, _ = read(crops[0], denoising=True, denoising_model="unet")
    np.testing.assert_array_equal(plain, unet)


@pytest.mark.parametrize("db_cls", [SQLiteDatabase, JSQLiteDatabase])
def test_sqlite_round_trip(db_cls):
    db = db_cls(":memory:")
    db.setup()
    sid = db.insert_song("song_a", "ABCD", 3)
    db.insert_hashes(sid, [("aa11", 5), ("bb22", 9), ("cc33", 12), ("aa11", 5)])
    db.set_song_fingerprinted(sid)
    assert db.get_num_songs() == 1 and db.get_num_fingerprints() == 3
    assert db.get_song_by_id(sid) == {"song_id": sid, "song_name": "song_a",
                                      "file_sha1": "ABCD", "total_hashes": 3}
    assert db.get_song_by_id(99) == {}
    assert db.get_songs() == [{"song_id": sid, "song_name": "song_a", "file_sha1": "ABCD",
                               "total_hashes": 3}]
    matches, dedup = db.return_matches([("AA11", 2), ("aa11", 4), ("bb22", 4)], batch_size=1)
    assert dedup == {sid: 2}
    assert sorted(matches) == [(sid, 1), (sid, 3), (sid, 5)]
    assert sorted(db.get_iterable_kv_pairs()) == [("AA11", sid, 5), ("BB22", sid, 9), ("CC33", sid, 12)]
    db.insert_song("ghost", "FF", 0)  # never fingerprinted
    db.delete_unfingerprinted_songs()
    assert db.get_num_songs() == 1
    db.delete_songs_by_id([sid])
    assert db.get_num_fingerprints() == 0
    db.insert_hashes(sid, [("dd44", 1)])
    db.empty()
    assert db.get_num_fingerprints() == 0 and db.get_songs() == []


def _strip(result):
    return {k: v for k, v in result.items() if k not in TIMINGS}


def test_dejavu_and_file_recognizer_match_jax(files):
    root, tracks, paths, crops = files
    djv = Dejavu({}, state="set", db=SQLiteDatabase(":memory:"), device="cpu")
    j_djv = JD.Dejavu({}, state="set", db=JSQLiteDatabase(":memory:"))
    djv.fingerprint_directory(paths)
    j_djv.fingerprint_directory(paths)
    assert djv.db.get_songs() == j_djv.db.get_songs()
    assert sorted(djv.db.get_iterable_kv_pairs()) == sorted(j_djv.db.get_iterable_kv_pairs())
    djv.fingerprint_directory(paths[:1])  # already stored: skipped
    assert djv.db.get_num_songs() == 4
    rec, j_rec = FileRecognizer(djv), JD.FileRecognizer(j_djv)
    queries = [str(root / "track_0.npy"), str(root / "track_1.pkl"), crops[2], paths[3],
               np.random.default_rng(5).standard_normal(2 * SR).astype(np.float32)]
    for q in queries:
        got, want = rec.recognize(q), j_rec.recognize(q)
        assert set(TIMINGS) <= set(got)
        assert _strip(got) == _strip(want)
    for q, name in zip(queries[:4], ("track_0", "track_1", "track_2", "track_3")):
        got = rec.recognize_file(q)
        assert got["match"] and got["results"][0]["song_name"].decode() == name


def test_fingerprint_arrays_and_batch_match_jax(files):
    _, tracks, _, crops = files
    names = [f"t{i}" for i in range(len(tracks))]
    djv = Dejavu({}, state="set", db=SQLiteDatabase(":memory:"), device="cpu")
    j_djv = JD.Dejavu({}, state="set", db=JSQLiteDatabase(":memory:"))
    djv.fingerprint_arrays(names, tracks)
    j_djv.fingerprint_arrays(names, tracks)
    assert djv.db.get_songs() == j_djv.db.get_songs()
    assert sorted(djv.db.get_iterable_kv_pairs()) == sorted(j_djv.db.get_iterable_kv_pairs())
    batch = np.stack(crops)
    got = djv.fingerprint_batch(batch)
    assert got == j_djv.fingerprint_batch(batch)
    for i, crop in enumerate(crops):
        assert sorted(got[i]) == sorted(fingerprint(crop * 32767.0, device="cpu"))
    assert djv.fingerprint_batch(batch * 32767.0, scaled=True) == got
    hashes, seconds = djv.generate_fingerprints(crops[0] * 32767.0)
    assert hashes == j_djv.generate_fingerprints(crops[0] * 32767.0)[0] and seconds >= 0
    mask, sgram = djv.generate_fingerprints(crops[1], get_masks=True)
    j_mask, j_sgram = j_djv.generate_fingerprints(crops[1], get_masks=True)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_allclose(sgram, j_sgram, rtol=0, atol=1e-5 * float(np.abs(j_sgram).max()))


def test_dejavu_denoising_arms():
    """The UNet arm's hook reaches the spectrogram only when denoising with
    "unet"; a bad model name raises; the default device is the card."""
    calls = []

    def hook(sgram):
        calls.append(tuple(sgram.shape))
        return sgram.flip(-2)  # frequencies reversed

    x = next(synthetic_clean_batches(1, 2 * SR, seed=72, sample_rate=SR))[0] * 32767.0
    plain = Dejavu({}, db=SQLiteDatabase(":memory:"), device="cpu")
    unet = Dejavu({}, db=SQLiteDatabase(":memory:"), denoising=True, denoising_model="unet",
                  spec_denoiser=hook, device="cpu")
    assert unet.generate_fingerprints(x)[0] != plain.generate_fingerprints(x)[0]
    assert calls == [(1, 257, 61)]
    with pytest.raises(ValueError, match="'unet' or 'demucs'"):
        Dejavu({}, db=SQLiteDatabase(":memory:"), denoising=True, denoising_model="x", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Dejavu({}, db=SQLiteDatabase(":memory:"))


def test_sqlite_database_file_and_clear_state(tmp_path):
    path = str(tmp_path / "djv.sqlite")
    djv = Dejavu({"database": {"database": path}}, device="cpu")
    sid = djv.db.insert_song("a", "AA", 1)
    djv.db.insert_hashes(sid, [("ab", 1)])
    djv.db.set_song_fingerprinted(sid)
    again = Dejavu({"database": {"database": path}}, device="cpu")
    assert again.songhashes_set == {"AA"}
    cleared = Dejavu({"database": {"database": path}}, state="clear", device="cpu")
    assert cleared.db.get_num_songs() == 0 and os.path.exists(path)

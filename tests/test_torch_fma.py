"""The FMA selection and the three actions over it, port against the JAX
package (CPU): the port's csv/numpy selection equals JAX's pandas
``TestSet`` element by element on a generated ``tracks.csv`` of 12,330
rows (tied genre counts, a genre of exactly 900 and one of 901 after the
duration cut, missing genres and durations, 12 s and 13 s tracks, paths
with no metadata); the preprocessing ``main`` writes the same csv bytes;
``--action index`` of audfprint and of Dejavu on a small mp3 tree gives
the same hash table and the same Dejavu database as JAX's; ``--queries
cleans`` writes the same pickles.
"""

import os
import pickle
import sys

import numpy as np
import pandas as pd
import pytest

from musicfpaugment_torch.afp.audfprint import HashTable
from musicfpaugment_torch.afp.dejavu import SQLiteDatabase
from musicfpaugment_torch.data import mp3_encode, native
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches, write_fma_tracks_csv
from musicfpaugment_torch.testing import audfprint_exps as texps
from musicfpaugment_torch.testing import dejavu_exps as tdexps
from musicfpaugment_torch.testing import fma_preprocessing as tfma
from musicfpaugment_torch.testing import generate_queries as tgen
from musicfpaugment_torch.testing import parameters as tparams
from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
from musicfpaugment_tpu.afp.dejavu.sqlite_database import SQLiteDatabase as JSQLiteDatabase
from musicfpaugment_tpu.testing import audfprint_exps as jexps
from musicfpaugment_tpu.testing import dejavu_exps as jdexps
from musicfpaugment_tpu.testing import fma_preprocessing as jfma
from musicfpaugment_tpu.testing import generate_queries as jgen
from musicfpaugment_tpu.testing import parameters as jparams

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

# tracks over 12 s per genre; "Pop" also has 30 tracks of exactly 12 s, so
# it has 900 after the cut (dropped) and "Electronic" 901 (capped at 885)
GENRES = {
    "Rock": 1500, "Electronic": 901, "Pop": 900, "Experimental": 899,
    "Folk": 850, "Jazz": 850, "Hip-Hop": 700, "Classical": 700, "Country": 700,
    "International": 800, "Instrumental": 750, "Blues": 600, "Soul-RnB": 500,
    "Spoken": 400, "Old-Time / Historic": 300, "Easy Listening": 200,
}
N_NO_GENRE = 300
SR = 22050


def _metadata(seed=3):
    """(track ids, genres, durations) in a shuffled order."""
    genres, durations = [], []
    for g, n in GENRES.items():
        genres += [g] * n
        durations += [30 if i % 5 else 13 for i in range(n)]  # 13 s: kept
    genres += ["Pop"] * 30 + ["Rock"] * 40 + [None] * N_NO_GENRE
    durations += [12] * 30 + [5] * 30 + [None] * 10 + [30] * N_NO_GENRE
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(genres))
    tids = rng.choice(np.arange(2, 160_000), size=len(genres), replace=False)
    return [int(t) for t in tids], [genres[i] for i in order], [durations[i] for i in order]


def _tree(root, tids, genres, durations, extra_paths=()):
    """An FMA root with its tracks.csv, and one dataset directory for each
    package holding the same fma_large_preprocessed.txt."""
    fma = root / "fma"
    os.makedirs(fma / "fma_metadata", exist_ok=True)
    write_fma_tracks_csv(str(fma / "fma_metadata" / "tracks.csv"), tids, genres, durations)
    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = root / f"dataset_{who}"
        os.makedirs(dirs[who], exist_ok=True)
    return str(fma), dirs


def _point(monkeypatch, fma, dirs):
    monkeypatch.setattr(jfma, "FMA_ROOT", fma)
    monkeypatch.setattr(jfma, "DATASET_DIR", str(dirs["jax"]))
    monkeypatch.setenv("MFPA_FMA_ROOT", fma)
    monkeypatch.setenv("MFPA_DATASET_DIR", str(dirs["port"]))


def _write_list(dirs, paths):
    for d in dirs.values():
        with open(d / "fma_large_preprocessed.txt", "w") as fh:
            fh.write("\n".join(paths) + "\n")


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    root = tmp_path_factory.mktemp("fma_big")
    tids, genres, durations = _metadata()
    fma, dirs = _tree(root, tids, genres, durations)
    paths = [f"{fma}/fma_large/{str(t).zfill(6)[:3]}/{str(t).zfill(6)}.mp3" for t in tids]
    # two paths with no metadata row (left join: empty cells)
    paths = paths[:5000] + [f"{fma}/fma_large/999/999998.mp3"] + paths[5000:] + [f"{fma}/x.mp3"]
    _write_list(dirs, paths)
    return {"fma": fma, "dirs": dirs, "tids": tids, "genres": genres, "durations": durations}


def _jax_selection(csv_path):
    ts = jfma.TestSet(pd.read_csv(csv_path))
    ts.remove_short_tracks()
    return ts.remove_exceptions(ts.sample_queries()), ts


def _port_selection():
    ts = tfma.TestSet(tfma.preprocessed_table())
    ts.remove_short_tracks()
    return ts.remove_exceptions(ts.sample_queries()), ts


def test_track_metadata_equals_pandas(big, monkeypatch):
    _point(monkeypatch, big["fma"], big["dirs"])
    csv_path = os.path.join(big["fma"], "fma_metadata", "tracks.csv")
    got = tfma.read_track_metadata(csv_path)
    want = jfma.read_track_metadata(csv_path)
    assert got["file_paths"] == list(want["file_paths"])
    assert got["top_genre"] == [None if isinstance(g, float) else g for g in want["top_genre"]]
    np.testing.assert_array_equal(np.asarray(got["duration"], np.float64), want["duration"].to_numpy())
    assert tfma.load(csv_path)["file_paths"] == got["file_paths"]
    with pytest.raises(ValueError, match="cannot be opened"):
        tfma.load("echonest.csv")


def test_preprocessing_main_writes_the_same_csv(big, monkeypatch):
    _point(monkeypatch, big["fma"], big["dirs"])
    jfma.main()
    tfma.main()
    name = "fma_large_preprocessed.csv"
    got = open(big["dirs"]["port"] / name, "rb").read()
    assert got == open(big["dirs"]["jax"] / name, "rb").read()
    assert got.count(b"\n") == len(big["tids"]) + 3


def test_selection_equals_jax_element_by_element(big, monkeypatch):
    _point(monkeypatch, big["fma"], big["dirs"])
    jfma.main()
    tfma.main()
    want, j_ts = _jax_selection(big["dirs"]["jax"] / "fma_large_preprocessed.csv")
    got, t_ts = _port_selection()
    assert len(got) == len(want) > max(jfma.EXCEPTION_POSITIONS)
    assert got == want
    # the order of the genres and their counts after the cut, ties included
    assert t_ts._value_counts() == list(j_ts.dataset["top_genre"].value_counts().items())
    counts = dict(t_ts._value_counts())
    assert counts["Pop"] == 900 and counts["Electronic"] == 901
    assert counts["Folk"] == counts["Jazz"] and counts["Hip-Hop"] == counts["Country"]
    g_of = dict(zip(tfma.read_track_metadata(
        os.path.join(big["fma"], "fma_metadata", "tracks.csv"))["file_paths"], big["genres"]))
    picked = [g_of[p] for p in got]
    assert "Pop" not in picked and picked.count("Rock") <= 885 and None not in picked
    assert t_ts.get_samples_per_class()["Rock"] == 1500


def test_blacklist_and_file_list_equal_jax(tmp_path, monkeypatch):
    fma = tmp_path / "fma"
    names = ["fma_large/001/001376.mp3", "fma_large/001/001377.mp3", "fma_large/002/002001.mp3"]
    for n in names:
        os.makedirs(fma / os.path.dirname(n), exist_ok=True)
        (fma / n).write_bytes(b"")
    dirs = {"jax": tmp_path / "dj", "port": tmp_path / "dp"}
    for d in dirs.values():
        os.makedirs(d)
        (d / "fma_large_to_remove.txt").write_text(
            open(os.path.join(tfma.DEFAULT_DATASET_DIR, "fma_large_to_remove.txt")).read())
    _point(monkeypatch, str(fma), dirs)
    assert tfma.blacklist_paths() == jfma.blacklist_paths() and len(tfma.blacklist_paths()) > 190
    assert sorted(tfma.preprocessing_fma_large()) == sorted(jfma.preprocessing_fma_large())
    assert len(tfma.preprocessing_fma_large()) == 2  # 001376 is blacklisted
    assert tfma.track_id_to_path(2001) == jfma.track_id_to_path(2001) == str(fma / names[2])


def _encode_tracks(fma, tids, seconds, seed):
    batches = synthetic_clean_batches(1, int(max(seconds) * SR), SR, seed=seed)
    paths = []
    for tid, secs in zip(tids, seconds):
        x = next(batches)[0][: int(secs * SR)] * 0.8
        path = tfma.track_id_to_path(tid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        mp3_encode.encode_mp3(x, path, SR)
        paths.append(path)
    return paths


@pytest.fixture
def codecs():
    if not (native.mp3_available() and mp3_encode.available()):
        pytest.skip("libmpg123 or libmp3lame cannot be loaded")


def _run_jax(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    module.main()


def test_index_action_equals_jax_for_both_systems(codecs, tmp_path, monkeypatch):
    tids = [1376, 2001, 10256, 45002, 99107]
    fma, dirs = _tree(tmp_path, tids, ["Rock", "Pop", "Folk", "Rock", None], [30, 20, 13, 30, 30])
    _point(monkeypatch, fma, dirs)
    _encode_tracks(fma, tids, [5.0, 4.0, 5.0, 6.0, 3.0], seed=21)
    _write_list(dirs, sorted(tfma.preprocessing_fma_large()))
    jfma.main()
    tfma.main()
    monkeypatch.setitem(jparams.afp_db_paths, "audfprint", str(tmp_path / "jax.npz"))
    monkeypatch.setitem(tparams.afp_db_paths, "audfprint", str(tmp_path / "port.npz"))
    for who in ("jax", "port"):  # the Dejavu database is ./dejavu_fma (SQLite)
        os.makedirs(tmp_path / f"cwd_{who}")
        monkeypatch.chdir(tmp_path / f"cwd_{who}")
        if who == "jax":
            _run_jax(monkeypatch, jexps, ["--action", "index"])
            _run_jax(monkeypatch, jdexps, ["--action", "index"])
        else:
            texps.main(["--action", "index", "--device", "cpu"])
            tdexps.main(["--action", "index", "--device", "cpu"])
    t_ht, j_ht = HashTable(str(tmp_path / "port.npz")), JHashTable(str(tmp_path / "jax.npz"))
    assert t_ht.names == j_ht.names and len(t_ht.names) == len(tids)
    np.testing.assert_array_equal(t_ht.hashesperid, j_ht.hashesperid)
    np.testing.assert_array_equal(t_ht.counts, j_ht.counts)
    np.testing.assert_array_equal(t_ht.table, j_ht.table)
    assert min(t_ht.hashesperid) > 50
    t_db = SQLiteDatabase(str(tmp_path / "cwd_port" / "dejavu_fma"))
    j_db = JSQLiteDatabase(str(tmp_path / "cwd_jax" / "dejavu_fma"))
    assert t_db.get_songs() == j_db.get_songs() and len(t_db.get_songs()) == len(tids)
    assert sorted(t_db.get_iterable_kv_pairs()) == sorted(j_db.get_iterable_kv_pairs())


def test_index_action_skips_missing_files(codecs, tmp_path, monkeypatch, capsys):
    tids = [1376, 2001]
    fma, dirs = _tree(tmp_path, tids, ["Rock", "Pop"], [30, 30])
    _point(monkeypatch, fma, dirs)
    _encode_tracks(fma, tids[:1], [3.0], seed=5)
    _write_list(dirs, [tfma.track_id_to_path(t) for t in tids])
    tfma.main()
    monkeypatch.setitem(tparams.afp_db_paths, "audfprint", str(tmp_path / "port.npz"))
    monkeypatch.chdir(tmp_path)
    texps.main(["--action", "index", "--device", "cpu"])
    tdexps.main(["--action", "index", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "error with" in out and "Failed fingerprinting" in out
    assert HashTable(str(tmp_path / "port.npz")).names == [tfma.track_id_to_path(1376)]
    assert [s["song_name"] for s in SQLiteDatabase(str(tmp_path / "dejavu_fma")).get_songs()] == ["001376"]


def test_clean_queries_equal_jax(codecs, big, tmp_path, monkeypatch):
    _point(monkeypatch, big["fma"], big["dirs"])
    jfma.main()
    tfma.main()
    selected, _ = _port_selection()
    tids = [int(os.path.basename(p)[:-4]) for p in selected[:5]]
    _encode_tracks(big["fma"], tids, [9.0, 10.0, 9.5, 12.0, 9.0], seed=8)
    try:
        monkeypatch.setitem(jparams.queries_paths, "cleans", str(tmp_path / "jax"))
        monkeypatch.setitem(tparams.queries_paths, "cleans", str(tmp_path / "port"))
        _run_jax(monkeypatch, jgen, ["--queries", "cleans", "--save"])
        tgen.main(["--queries", "cleans", "--save", "--device", "cpu"])
    finally:
        for t in tids:
            os.remove(tfma.track_id_to_path(t))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == sorted(f"{str(t).zfill(6)}.pkl" for t in tids)
    for n in names:
        with open(tmp_path / "port" / n, "rb") as f:
            got = pickle.load(f)
        with open(tmp_path / "jax" / n, "rb") as f:
            want = pickle.load(f)
        assert got.shape == (8 * 8000,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))


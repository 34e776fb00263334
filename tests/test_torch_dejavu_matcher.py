"""The Dejavu CSR index and batched matcher, port against the JAX package and
against the port's own SQLite ``align_matches`` oracle (CPU).

Bit-identical: the finalized CSR arrays, the npz files either package saves,
the packed query hashes and every output of ``_dejavu_match_impl`` on the
same hashes, the lane tier against the full width, the int64 cell key
against the int32 one. Verdicts: every field of ``match_waveforms`` equal to
``align_matches`` over SQLite on the same corpus and queries, and to JAX's
matcher.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.afp.dejavu import Dejavu, DejavuDeviceIndex, DejavuDeviceMatcher
from musicfpaugment_torch.afp.dejavu.sqlite_database import SQLiteDatabase
from musicfpaugment_tpu.afp import dejavu as JD

from torch_port_helpers import few_threads  # noqa: F401

tm = importlib.import_module("musicfpaugment_torch.afp.dejavu.matcher_device")
jm = importlib.import_module("musicfpaugment_tpu.afp.dejavu.matcher_device")
tf = importlib.import_module("musicfpaugment_torch.afp.dejavu.fingerprint")
jf = importlib.import_module("musicfpaugment_tpu.afp.dejavu.fingerprint")

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
N_TRACKS = 6
TRACK_SECONDS = 10


def tone_tracks(rng, n, seconds):
    """Decaying tone bursts, each track peak-normalised (the JAX package's
    Dejavu test corpus)."""
    out = []
    for _ in range(n):
        t = np.arange(seconds * SR)
        x = np.zeros(len(t), np.float32)
        for _ in range(seconds * 25):
            f = rng.uniform(80, 3500)
            s = int(rng.integers(0, len(t) - SR // 8))
            d = int(rng.integers(SR // 16, SR // 4))
            seg = np.arange(min(d, len(t) - s))
            x[s : s + len(seg)] += (np.sin(2 * np.pi * f * seg / SR) * np.exp(-8 * seg / SR)).astype(
                np.float32
            )
        out.append(x / np.abs(x).max())
    return np.stack(out)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(59)
    tracks = tone_tracks(rng, N_TRACKS, TRACK_SECONDS)
    names = [f"song_{i:02d}" for i in range(N_TRACKS)]
    t_idx = DejavuDeviceIndex()
    t_idx.ingest_arrays(names, tracks, device="cpu")
    j_idx = JD.DejavuDeviceIndex()
    j_idx.ingest_arrays(names, tracks)
    djv = Dejavu({}, state="set", db=SQLiteDatabase(":memory:"), device="cpu")
    djv.fingerprint_arrays(names, tracks)
    return tracks, names, t_idx, j_idx, djv


def _queries(tracks, seconds, rng):
    """A crop of every track, a lightly noisy crop of track 0 and pure
    noise (no match)."""
    n = seconds * SR
    crops = [tracks[i, s : s + n] for i, s in
             enumerate(rng.integers(0, tracks.shape[1] - n, len(tracks)))]
    crops.append(crops[0] + 0.01 * rng.standard_normal(n).astype(np.float32))
    crops.append(rng.standard_normal(n).astype(np.float32))
    return np.stack(crops).astype(np.float32)


def test_finalize_equals_jax(corpus):
    _, _, t_idx, j_idx, _ = corpus
    assert t_idx.names == j_idx.names and t_idx.total_hashes == j_idx.total_hashes
    got, want = t_idx.finalize(), j_idx.finalize()
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2:] == want[2:]
    assert t_idx.rows_dropped == j_idx.rows_dropped == 0


def test_add_song_finalize_equals_jax():
    rng = np.random.default_rng(4)
    t_idx, j_idx = DejavuDeviceIndex(max_rows_per_hash=4), JD.DejavuDeviceIndex(max_rows_per_hash=4)
    for i in range(7):
        hashes = [(int(k), int(t)) for k, t in zip(rng.integers(0, 40, 40), rng.integers(0, 900, 40))]
        assert t_idx.add_song(f"s{i}", hashes) == j_idx.add_song(f"s{i}", hashes) == i
    for g, w in zip(t_idx.finalize(), j_idx.finalize()):
        np.testing.assert_array_equal(g, w)
    assert t_idx.rows_dropped == j_idx.rows_dropped > 0
    with pytest.raises(ValueError, match="timebits"):
        t_idx.add_song("late", [(1, 1 << 14)])


def test_npz_loads_across_packages(corpus, tmp_path):
    _, _, t_idx, j_idx, _ = corpus
    j_idx.save(str(tmp_path / "jax.npz"))
    t_idx.save(str(tmp_path / "port.npz"))
    from_jax = DejavuDeviceIndex.load(str(tmp_path / "jax.npz"))
    from_port = JD.DejavuDeviceIndex.load(str(tmp_path / "port.npz"))
    for idx in (from_jax, from_port):
        assert idx.names == t_idx.names and idx.total_hashes == t_idx.total_hashes
        assert (idx.timebits, idx.max_rows_per_hash) == (t_idx.timebits, t_idx.max_rows_per_hash)
        for g, w in zip(idx.finalize(), t_idx.finalize()):
            np.testing.assert_array_equal(g, w)
    assert sorted(tmp_path.iterdir()) == [tmp_path / "jax.npz", tmp_path / "port.npz"]


def _packed(tracks, seconds, rng, st=tf.DEFAULT_SETTINGS):
    q = _queries(tracks, seconds, rng)
    n_frames = tm._n_frames(q.shape[1], st)
    mp = tm._pow2ceil(4 * n_frames)
    _, masks, _ = jf.fingerprint_spectrogram_batch(jnp.asarray(q))
    return np.array(masks), mp, n_frames


@pytest.mark.parametrize("seconds", [2, 8])
def test_match_impl_bit_identical_to_jax(corpus, seconds):
    tracks, _, t_idx, _, _ = corpus
    masks, mp, n_frames = _packed(tracks, seconds, np.random.default_rng(seconds))
    t_hashes = tf.pack_hashes_from_masks(torch.from_numpy(masks), mp)
    j_hashes = jf.pack_hashes_from_masks(jnp.asarray(masks), mp)
    for g, w in zip(t_hashes, j_hashes):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    t_dm = DejavuDeviceMatcher(t_idx, device="cpu")
    j_dm = JD.DejavuDeviceMatcher(t_idx)
    kw = t_dm._match_kwargs(t_dm._effective_mqf(n_frames))
    assert kw == dict(depth=j_dm.depth, num_ids=j_dm.num_ids, timebits=t_idx.timebits,
                      mqf=j_dm._effective_mqf(n_frames), max_store_time=j_dm.eff_maxtime,
                      nbuckets=j_dm.nbuckets)
    got = tm._dejavu_match_impl(t_dm._starts, t_dm._rows, *t_hashes[:4], **kw)
    want = jm._dejavu_match_impl(j_dm._starts, j_dm._rows, *j_hashes[:4], **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][:N_TRACKS] == torch.arange(N_TRACKS, dtype=torch.int32)).all()


def test_lane_tier_and_int64_cells_are_bit_identical(corpus):
    """Lanes past the widest used one hold only invalid keys, whose cells
    sort last: the tier equals the full width. A corpus with too many ids for
    int32 cells takes int64 ones: the same verdicts."""
    tracks, _, t_idx, _, _ = corpus
    masks, mp, n_frames = _packed(tracks, 2, np.random.default_rng(11))
    keys, t1, valid, kf, _, _ = tf.pack_hashes_from_masks(torch.from_numpy(masks), mp)
    dm = DejavuDeviceMatcher(t_idx, device="cpu")
    kw = dm._match_kwargs(dm._effective_mqf(n_frames))
    full = tm._dejavu_match_impl(dm._starts, dm._rows, keys, t1, valid, kf, **kw)
    n_used = int((keys < tf.INVALID_KEY).sum(dim=-1).max())
    tier = tm._pow2ceil(max(n_used, 16))
    assert tier < keys.shape[1], "queries too dense for the tier test"
    tiered = tm._dejavu_match_impl(
        dm._starts, dm._rows, keys[:, :tier], t1[:, :tier], valid[:, :tier], kf[:, :tier], **kw
    )
    T3 = kw["max_store_time"] + kw["mqf"] + 3
    wide = dict(kw, num_ids=(2**31) // T3 + 1)
    as_int64 = tm._dejavu_match_impl(dm._starts, dm._rows, keys, t1, valid, kf, **wide)
    for f, t, w in zip(full, tiered, as_int64):
        assert torch.equal(f, t) and torch.equal(f, w)


def test_hot_hash_cap_truncates_deterministically():
    idx = DejavuDeviceIndex(max_rows_per_hash=3)
    for sid in range(6):
        idx.add_song(f"s{sid}", [(12345, 10 - sid), (777, sid)])
    starts, rows, nbuckets, depth = idx.finalize()
    assert idx.rows_dropped == 6 and depth == 3  # 3 of each key's 6 rows
    kept = rows[starts[12345] : starts[12346]]
    np.testing.assert_array_equal((kept >> np.uint32(idx.timebits)).astype(int), [0, 1, 2])
    np.testing.assert_array_equal((kept & np.uint32((1 << idx.timebits) - 1)).astype(int), [10, 9, 8])
    again = DejavuDeviceIndex(max_rows_per_hash=3)
    for sid in range(6):
        again.add_song(f"s{sid}", [(777, sid), (12345, 10 - sid)])
    for g, w in zip(again.finalize(), (starts, rows, nbuckets, depth)):
        np.testing.assert_array_equal(g, w)


def _key(f1, f2, dt):
    return (f1 << 17) | (f2 << 8) | dt


def test_exact_ties_break_as_align_matches():
    """Two songs with the same top count: the lower song id wins; within a
    song, two offsets with the same count: the lower offset wins. Port, JAX
    and align_matches over SQLite agree on every field."""
    k1, k2, k3 = _key(10, 20, 3), _key(30, 40, 5), _key(50, 60, 7)
    songs = [
        [(k1, 10), (k2, 20)],  # offset 10, twice
        [(k1, 5), (k2, 15)],  # offset 5, twice: ties with song 0
        [(k3, 7), (k3, 9), (k1, 40)],  # offsets 7, 9 and 40 once each
    ]
    queries = [[(k1, 0), (k2, 10)], [(k3, 0)], [(k1, 3)]]
    idx, j_idx = DejavuDeviceIndex(), JD.DejavuDeviceIndex()
    djv = Dejavu({}, state="set", db=SQLiteDatabase(":memory:"), device="cpu")
    for i, hashes in enumerate(songs):
        idx.add_song(f"s{i}", hashes)
        j_idx.add_song(f"s{i}", hashes)
        sid = djv.db.insert_song(f"s{i}", f"{i:040x}", len(hashes))
        djv.db.insert_hashes(sid, [(f"{k:07x}", t) for k, t in hashes])
        djv.db.set_song_fingerprinted(sid)
    dm = DejavuDeviceMatcher(idx, device="cpu")
    j_dm = JD.DejavuDeviceMatcher(j_idx)
    H = 8
    keys = np.full((len(queries), H), tf.INVALID_KEY, np.int32)
    t1 = np.zeros((len(queries), H), np.int32)
    for qi, q in enumerate(queries):
        for hi, (k, t) in enumerate(sorted(q)):
            keys[qi, hi], t1[qi, hi] = k, t
    valid = keys < tf.INVALID_KEY
    kf = valid & np.concatenate([np.ones((len(queries), 1), bool), keys[:, 1:] != keys[:, :-1]], 1)
    kw = dm._match_kwargs(dm._effective_mqf(16))
    got = tm._dejavu_match_impl(dm._starts, dm._rows, *(torch.from_numpy(a) for a in (keys, t1, valid, kf)), **kw)
    want = jm._dejavu_match_impl(j_dm._starts, j_dm._rows, *(jnp.asarray(a) for a in (keys, t1, valid, kf)), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    best_sid, best_count, best_dt, dedup = (g.tolist() for g in got)
    assert best_sid == [0, 2, 0] and best_count == [2, 1, 1] and best_dt == [10, 7, 7]
    for qi, q in enumerate(queries):
        hashes = {(f"{k:07x}", t) for k, t in q}
        matches, dedup_db, _ = djv.find_matches(hashes)
        top = djv.align_matches(matches, dedup_db, len(hashes))[0]
        assert (top["song_id"] - 1, top["nb_matches_with_offset"], top["offset"],
                top["hashes_matched_in_input"]) == (best_sid[qi], best_count[qi], best_dt[qi], dedup[qi])


FIELDS = ("song_name", "nb_matches_with_offset", "hashes_matched_in_input", "input_total_hashes",
          "fingerprinted_hashes_in_db", "offset", "offset_seconds", "input_confidence",
          "input_confidence_2", "fingerprinted_confidence")


@pytest.mark.parametrize("seconds", [2, 8])
def test_match_waveforms_equals_sqlite_oracle_and_jax(corpus, seconds):
    tracks, names, t_idx, j_idx, djv = corpus
    assert t_idx.total_hashes == [djv.db.get_song_by_id(i + 1)["total_hashes"] for i in range(N_TRACKS)]
    queries = _queries(tracks, seconds, np.random.default_rng(100 + seconds))
    dm = DejavuDeviceMatcher(t_idx, device="cpu")
    got = dm.match_waveforms(queries)
    assert got == JD.DejavuDeviceMatcher(j_idx).match_waveforms(queries)
    for q, dev in zip(queries, got):
        fps, _ = djv.generate_fingerprints(q)
        hashes = set(fps)
        matches, dedup, _ = djv.find_matches(hashes)
        host = djv.align_matches(matches, dedup, len(hashes))
        if not host:
            assert dev == {}
            continue
        for field in FIELDS:
            assert dev[field] == host[0][field], field
        assert dev["song_id"] == host[0]["song_id"] - 1  # SQLite counts from 1
    verdicts = dm.recognize_waveforms(queries)
    assert verdicts == JD.DejavuDeviceMatcher(j_idx).recognize_waveforms(queries)
    gts = names + [names[0], None]
    for v, gt in zip(verdicts, gts):
        if gt is None:
            assert not v["match"]
        else:
            assert v["match"] and v["results"][0]["song_name"].decode() == gt


def test_empty_corpus_mesh_and_overflow(corpus):
    tracks, _, t_idx, _, _ = corpus
    empty = DejavuDeviceMatcher(DejavuDeviceIndex(), device="cpu")
    assert empty.match_waveforms(tracks[:2, : 2 * SR]) == [{}, {}]
    assert empty.recognize_waveforms(tracks[:1, : 2 * SR]) == [{"results": [], "match": False}]
    meshed = DejavuDeviceMatcher(t_idx, mesh=["cpu", "cpu"])
    assert meshed.device == torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        meshed.match_waveforms(tracks[:3, : 2 * SR])
    dm = DejavuDeviceMatcher(t_idx, device="cpu")
    with pytest.warns(UserWarning, match="8-peak budget"):
        dm.match_waveforms(tracks[:2, : 2 * SR], max_peaks=8)
    with pytest.warns(UserWarning, match="8-peak budget"):
        DejavuDeviceIndex().ingest_arrays(["a"], tracks[:1, : 2 * SR], max_peaks=8, device="cpu")
    with pytest.raises(ValueError, match="names"):
        DejavuDeviceIndex().ingest_arrays(["a", "b"], tracks[:1], device="cpu")
    assert dm.index_bytes() == dm._starts.numel() * 4 + dm._rows.numel() * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DejavuDeviceMatcher(t_idx)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DejavuDeviceIndex().ingest_arrays(["a"], tracks[:1])

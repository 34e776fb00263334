"""Port parity: HashTable, hash_table_from_arrays and the device matcher
against the JAX package. Store and match are integer and sort arithmetic
(the weighted counts are the same float32 divisions), so tables and match
outputs must be bit-identical.

Tables use depth 20 to keep two host tables (JAX and port) small.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_tpu.afp.audfprint import DeviceMatcher as JDeviceMatcher
from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
from musicfpaugment_tpu.afp.audfprint.matcher_device import _match_impl as j_match_impl
from musicfpaugment_torch.afp.audfprint import DeviceMatcher, HashTable
from musicfpaugment_torch.afp.audfprint.matcher_device import _match_impl
from musicfpaugment_torch.convert import hash_table_from_arrays

DEPTH = 20


def _synthetic_tracks(rng, n_tracks=24, hashes_per_track=400):
    """(time, hash) arrays with track-distinct vocabularies plus 20% hashes
    shared across the corpus, so candidates collide."""
    tracks = []
    for _ in range(n_tracks):
        times = np.sort(rng.integers(0, 900, hashes_per_track)).astype(np.int64)
        own = rng.integers(0, 2**20, hashes_per_track)
        shared = rng.integers(0, 5000, hashes_per_track)
        use_shared = rng.random(hashes_per_track) < 0.2
        tracks.append(np.stack([times, np.where(use_shared, shared, own)], axis=1))
    # an exact duplicate track: equal weighted counts, the tie-break case
    tracks.append(tracks[3].copy())
    return tracks


def _queries(tracks, rng, n=32):
    qs = []
    for qi in range(n):
        if qi % 4 == 3:  # junk query: should NOMATCH
            t = np.sort(rng.integers(0, 250, 80))
            qs.append(np.stack([t, rng.integers(2**19, 2**20, 80)], axis=1))
            continue
        ti = 3 if qi % 8 == 1 else int(rng.integers(0, len(tracks)))
        th = tracks[ti]
        start = int(rng.integers(0, 600))
        sel = th[(th[:, 0] >= start) & (th[:, 0] < start + 250)].copy()
        sel[:, 0] -= start
        bad = rng.random(len(sel)) < 0.3  # augmentation damage
        sel[bad, 1] = rng.integers(0, 2**20, bad.sum())
        qs.append(sel)
    return qs


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    tracks = _synthetic_tracks(rng)
    t_ht, j_ht = HashTable(depth=DEPTH), JHashTable(depth=DEPTH)
    for i, th in enumerate(tracks):
        t_ht.store(f"track{i:03d}", th)
        j_ht.store(f"track{i:03d}", th)
    return t_ht, j_ht, tracks


def _assert_tables_equal(a, b):
    np.testing.assert_array_equal(a.table, b.table)
    assert a.table.dtype == b.table.dtype == np.uint32
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.hashesperid, b.hashesperid)
    assert list(a.names) == list(b.names)
    assert (a.hashbits, a.depth, a.maxtimebits) == (b.hashbits, b.depth, b.maxtimebits)


def test_store_byte_identical_including_reservoir():
    """Small buckets force reservoir sampling: both draw the same
    default_rng(0) stream."""
    rng = np.random.default_rng(11)
    t_ht = HashTable(hashbits=8, depth=DEPTH)
    j_ht = JHashTable(hashbits=8, depth=DEPTH)
    for i in range(12):
        th = np.stack([np.sort(rng.integers(0, 900, 300)), rng.integers(0, 256, 300)], axis=1)
        t_ht.store(f"t{i}", th)
        j_ht.store(f"t{i}", th)
    assert int(t_ht.counts.max()) > DEPTH
    _assert_tables_equal(t_ht, j_ht)


def test_npz_round_trip_both_ways(corpus, tmp_path):
    t_ht, j_ht, _ = corpus
    j_ht.save(str(tmp_path / "from_jax"))
    _assert_tables_equal(HashTable(str(tmp_path / "from_jax.npz")), j_ht)
    t_ht.save(str(tmp_path / "from_torch"))
    _assert_tables_equal(JHashTable(str(tmp_path / "from_torch.npz")), t_ht)


def test_hash_table_from_arrays(corpus):
    _, j_ht, tracks = corpus
    ht = hash_table_from_arrays(
        j_ht.table, j_ht.counts, j_ht.names, j_ht.hashesperid,
        [j_ht.hashbits, j_ht.depth, j_ht.maxtimebits, j_ht.ht_version],
    )
    _assert_tables_equal(ht, j_ht)
    assert ht.table is not j_ht.table  # a copy, not a view
    extra = tracks[0][:50]
    ht.store("extra", extra)
    j_ht2 = JHashTable(depth=DEPTH)
    j_ht2.table, j_ht2.counts = j_ht.table.copy(), j_ht.counts.copy()
    j_ht2.names, j_ht2.hashesperid = list(j_ht.names), j_ht.hashesperid.copy()
    j_ht2.store("extra", extra)
    _assert_tables_equal(ht, j_ht2)


def _matchers(corpus):
    t_ht, j_ht, _ = corpus
    return DeviceMatcher(t_ht, device="cpu"), JDeviceMatcher(j_ht)


def test_refresh_state_matches_jax(corpus):
    t_dm, j_dm = _matchers(corpus)
    assert (t_dm.eff_depth, t_dm.eff_maxtime, t_dm.num_ids) == (
        j_dm.eff_depth, j_dm.eff_maxtime, j_dm.num_ids
    )
    np.testing.assert_array_equal(t_dm._table.numpy(), np.asarray(j_dm._table).astype(np.int32))
    np.testing.assert_array_equal(t_dm._counts.numpy(), np.asarray(j_dm._counts))
    np.testing.assert_array_equal(t_dm._hpit.numpy(), np.asarray(j_dm._hpit))


def _padded(queries, H=256):
    B = len(queries)
    qt = np.zeros((B, H), np.int32)
    qh = np.zeros((B, H), np.int32)
    qv = np.zeros((B, H), bool)
    for i, q in enumerate(queries):
        n = min(len(q), H)
        qt[i, :n], qh[i, :n], qv[i, :n] = q[:n, 0], q[:n, 1], True
    return qt, qh, qv


@pytest.mark.parametrize("cell_budget", [16384, 256])
def test_match_impl_bit_identical(corpus, cell_budget):
    t_dm, j_dm = _matchers(corpus)
    _, _, tracks = corpus
    qt, qh, qv = _padded(_queries(tracks, np.random.default_rng(9)))
    kw = j_dm._match_kwargs(512)
    kw["cell_budget"] = cell_budget
    got = _match_impl(
        t_dm._table, t_dm._counts, t_dm._hpit,
        torch.from_numpy(qt), torch.from_numpy(qh), torch.from_numpy(qv), **kw,
    )
    want = j_match_impl(
        j_dm._table, j_dm._counts, j_dm._hpit,
        jnp.asarray(qt), jnp.asarray(qh), jnp.asarray(qv), **kw,
    )
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3] == int(want[3])
    assert (got[0].numpy() >= 0).sum() >= 16  # the true crops match


def test_match_hashes_batch_equal_verdicts(corpus):
    t_dm, j_dm = _matchers(corpus)
    _, _, tracks = corpus
    queries = _queries(tracks, np.random.default_rng(21))
    queries.append(np.zeros((0, 2), np.int64))  # an empty query
    got = t_dm.match_hashes_batch(queries)
    assert got == j_dm.match_hashes_batch(queries)
    assert got[-1] == ("NOMATCH", "", 0)
    assert sum(v[0] == "MATCH" for v in got) >= 16
    assert t_dm.match_hashes_batch([]) == []


def test_match_shallow_table_more_ids_than_hits():
    """eff_depth 1 and 64 hash lanes give 64 hits per query, fewer than the
    100 candidates a 150-id corpus allows: the candidate list shrinks to the
    hits instead of failing."""
    ht = HashTable(depth=DEPTH)
    for i in range(150):
        ht.store(f"t{i}", np.array([[i, 1000 + i]]))
    own = np.stack([np.arange(40) + 3, np.arange(40) + 5000], axis=1)
    ht.store("target", own)
    dm = DeviceMatcher(ht, device="cpu")
    assert dm.eff_depth == 1 and dm.num_ids == 151
    q = own[5:35].copy()
    q[:, 0] -= 5
    assert dm.match_hashes_batch([q]) == [("MATCH", "target", 30)]

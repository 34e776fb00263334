"""The port's numpy ``Matcher`` oracle and the ``HashTable`` methods it and
the single-file API read, against the JAX package's numpy ones (identical),
and the sequential ``compute_accuracy`` against ``compute_accuracy_batched``
with and without the device matcher (equal accuracies)."""

import numpy as np
import pytest
import torch

from musicfpaugment_torch.afp.audfprint import (
    AudfprintPeaks,
    DeviceMatcher,
    HashTable,
    Matcher,
    landmarks2hashes,
)
from musicfpaugment_torch.afp.audfprint import analyzer as tan
from musicfpaugment_torch.afp.audfprint import matcher as tmatcher
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.testing import audfprint_exps as texps
from musicfpaugment_torch.testing.parameters import afp_settings
from musicfpaugment_tpu.afp.audfprint import AudfprintPeaks as JAudfprintPeaks
from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
from musicfpaugment_tpu.afp.audfprint import Matcher as JMatcher
from musicfpaugment_tpu.afp.audfprint import analyzer as jan
from musicfpaugment_tpu.afp.audfprint import matcher as jmatcher

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
N_TRACKS = 6


def _random_hashes(rng, n, tmax=400):
    return np.stack([rng.integers(0, tmax, n), rng.integers(0, 1 << 20, n)], axis=1).astype(np.int32)


@pytest.fixture(scope="module")
def tables():
    """Equal tables in both packages: 12 ids of random hashes, shallow
    enough (depth 4) for some buckets to overflow."""
    rng = np.random.default_rng(0)
    t_ht, j_ht = HashTable(hashbits=12, depth=4), JHashTable(hashbits=12, depth=4)
    stored = {}
    for i in range(12):
        h = _random_hashes(rng, 300)
        h[:, 1] &= (1 << 12) - 1
        stored[f"id{i}"] = h
        t_ht.store(f"id{i}", h)
        j_ht.store(f"id{i}", h)
    return t_ht, j_ht, stored


def _same_table(t_ht, j_ht):
    np.testing.assert_array_equal(t_ht.table, j_ht.table)
    np.testing.assert_array_equal(t_ht.counts, j_ht.counts)
    np.testing.assert_array_equal(t_ht.hashesperid, j_ht.hashesperid)
    assert t_ht.names == j_ht.names


def test_hash_table_lookups_equal_jax(tables):
    t_ht, j_ht, stored = tables
    _same_table(t_ht, j_ht)
    q = np.concatenate([stored["id3"][:50], _random_hashes(np.random.default_rng(1), 30)])
    q[:, 1] &= (1 << 12) - 1
    np.testing.assert_array_equal(t_ht.get_hits(q), j_ht.get_hits(q))
    assert t_ht.get_hits(q).dtype == np.int32 and len(t_ht.get_hits(q)) > 50
    assert t_ht.get_hits(np.zeros((0, 2), np.int32)).shape == (0, 4)
    for got, want in zip(t_ht.get_hits_dense(q), j_ht.get_hits_dense(q)):
        np.testing.assert_array_equal(got, want)
    busiest = int(np.argmax(t_ht.counts))
    for h in (busiest, int(q[0, 1])):
        np.testing.assert_array_equal(t_ht.get_entry(h), j_ht.get_entry(h))
    for name in ("id0", "id7", 3):
        np.testing.assert_array_equal(t_ht.retrieve(name), j_ht.retrieve(name))
    assert len(t_ht.retrieve("id0")) > 0
    t_lines, j_lines = [], []
    t_ht.list(t_lines.append), j_ht.list(j_lines.append)
    assert t_lines == j_lines and len(t_lines) == 12 and t_lines[0].startswith("id0 (")


def test_hash_table_remove_reuse_and_reset_equal_jax():
    rng = np.random.default_rng(2)
    t_ht, j_ht = HashTable(hashbits=10, depth=6), JHashTable(hashbits=10, depth=6)
    hashes = [_random_hashes(rng, 200) for _ in range(5)]
    for ht in (t_ht, j_ht):
        for i, h in enumerate(hashes[:4]):
            ht.store(f"t{i}", h)
        ht.remove("t1")
    _same_table(t_ht, j_ht)
    assert t_ht.names[1] is None and len(t_ht.retrieve(1)) == 0
    with pytest.raises(ValueError, match="not found"):
        t_ht.name_to_id("t1")
    for ht in (t_ht, j_ht):
        ht.store("new", hashes[4])  # takes the freed id
    _same_table(t_ht, j_ht)
    assert t_ht.name_to_id("new") == 1 and t_ht.hashesperid[1] == 200
    # a freed id survives the npz round trip, in either direction
    import os, tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for ht in (t_ht, j_ht):
            ht.remove("t2")
        t_ht.save(os.path.join(tmp, "t"))
        back = JHashTable(os.path.join(tmp, "t"))
        again = HashTable(os.path.join(tmp, "t"))
    _same_table(again, back)
    for ht in (again, back):
        ht.store("later", hashes[0])
    assert again.name_to_id("later") == back.name_to_id("later") == 2
    for ht in (t_ht, j_ht):
        ht.reset()
    _same_table(t_ht, j_ht)
    assert t_ht.names == [] and t_ht.totalhashes() == 0


def test_matcher_helpers_equal_jax():
    rng = np.random.default_rng(3)
    vec = rng.integers(0, 6, 40).astype(np.float32)
    for v in (1, 2, 3, 1000, 1025):
        assert tmatcher.encpowerof2(v) == jmatcher.encpowerof2(v)
    np.testing.assert_array_equal(tmatcher.locmax(vec), jmatcher.locmax(vec))
    np.testing.assert_array_equal(tmatcher.locmax(vec, True), jmatcher.locmax(vec, True))
    np.testing.assert_array_equal(tan.locmax(vec, True), jan.locmax(vec, True))
    np.testing.assert_array_equal(tmatcher.keep_local_maxes(vec), jmatcher.keep_local_maxes(vec))
    data = rng.integers(-5, 20, 300)
    for got, want in zip(tmatcher.find_modes(data, 5), jmatcher.find_modes(data, 5)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exact_count,find_time_range", [(False, False), (True, False), (False, True), (True, True)])
def test_matcher_results_equal_jax(tables, exact_count, find_time_range):
    t_ht, j_ht, stored = tables
    tm, jm = Matcher(), JMatcher()
    for m in (tm, jm):
        m.exact_count, m.find_time_range, m.max_returns = exact_count, find_time_range, 3
    rng = np.random.default_rng(4)
    for name in ("id2", "id9"):
        q = stored[name][rng.permutation(300)[:120]].copy()
        q[:, 0] -= 17  # a query cut 17 frames into the track
        q = np.concatenate([q[q[:, 0] >= 0], _random_hashes(rng, 40) & np.array([0xFFFF, 0xFFF])])
        got, got_hashes = tm.match_hashes(t_ht, q, hashesfor=0)
        want, want_hashes = jm.match_hashes(j_ht, q, hashesfor=0)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_hashes, want_hashes)
        assert got.shape[1] == 7 and t_ht.names[got[0, 0]] == name and got[0, 2] == 17
        assert tm.hashes_match_to_msgs(t_ht, q) == jm.hashes_match_to_msgs(j_ht, q)
        assert tm.hashes_match_to_msgs(t_ht, q)[:2] == ("MATCH", name)
    noise = _random_hashes(rng, 50) & np.array([0xFFFF, 0xFFF])
    assert tm.hashes_match_to_msgs(t_ht, noise) == jm.hashes_match_to_msgs(j_ht, noise)
    empty = np.zeros((0, 2), np.int32)
    assert tm.hashes_match_to_msgs(t_ht, empty) == ("NOMATCH", "", 0)
    assert tm.match_hashes(t_ht, empty)[0].shape == (0, 7)


@pytest.fixture(scope="module")
def corpus():
    """Six 10 s tracks, the port's table over them, and 12 queries: a clean
    2.5 s crop of each track and the same crop in noise."""
    tracks = next(synthetic_clean_batches(N_TRACKS, 10 * SR, seed=41, sample_rate=SR))
    names = [f"dir/trk{i}.wav" for i in range(N_TRACKS)]
    analyzer = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    ht = HashTable(depth=20)
    analyzer.ingest_batch(ht, names, tracks)
    rng = np.random.default_rng(6)
    crops = np.stack([t[3 * SR + 100 * i :][: 5 * SR // 2] for i, t in enumerate(tracks)])
    noisy = crops + 0.5 * crops.std() * rng.standard_normal(crops.shape).astype(np.float32)
    queries = np.concatenate([crops, noisy]).astype(np.float32)
    return {"tracks": tracks, "names": names, "ht": ht, "queries": queries,
            "query_names": [f"q/trk{i}.pkl" for i in range(N_TRACKS)] * 2}


def test_single_file_api_equals_jax(corpus, tmp_path):
    t_an = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    j_an = JAudfprintPeaks(afp_settings["audfprint"])
    wave = corpus["queries"][0]
    path = str(tmp_path / "q.npy")
    np.save(path, wave)
    pk_t, mask_t, spec_t = t_an.find_peaks(wave)
    pk_j, mask_j, spec_j = j_an.find_peaks(wave)
    assert mask_t.shape == mask_j.shape == (256, 79) and mask_t.dtype == np.float32
    assert spec_t.shape == spec_j.shape == (257, 79)
    np.testing.assert_allclose(spec_t, spec_j, rtol=0, atol=1e-5)
    assert (mask_t == mask_j).mean() >= 0.999 and mask_t.sum() > 20
    assert pk_t == [(c, b) for c, b in zip(*np.nonzero(mask_t.T))]
    assert t_an.find_peaks(np.zeros(0, np.float32))[0] == []
    # landmarks and hashes from the same peak list: identical
    lms = t_an.peaks2landmarks(pk_j)
    assert lms == j_an.peaks2landmarks(pk_j) and len(lms) > 20
    np.testing.assert_array_equal(landmarks2hashes(lms), jan.landmarks2hashes(lms))
    assert landmarks2hashes([]).shape == (0, 2)
    vec = np.random.default_rng(7).random(64).astype(np.float32)
    np.testing.assert_allclose(t_an.spreadpeaksinvector(vec, 4.0), j_an.spreadpeaksinvector(vec, 4.0))
    np.testing.assert_allclose(
        t_an.spreadpeaks([(3, 1.0), (40, 0.5)], base=vec), j_an.spreadpeaks([(3, 1.0), (40, 0.5)], base=vec))
    with pytest.raises(ValueError, match="npoints or base"):
        t_an.spreadpeaks([(3, 1.0)])
    # the file entry points
    assert t_an.wavfile2peaks(path) == pk_t
    by_shift = t_an.wavfile2peaks(path, shifts=4)
    assert len(by_shift) == 4 and by_shift[0] == pk_t and by_shift[1] != pk_t
    mask, d, sgram = t_an.wavfile2peaks(path, get_masks_waveforms=True)
    np.testing.assert_array_equal(mask, mask_t)
    np.testing.assert_array_equal(d, wave)
    np.testing.assert_array_equal(sgram, spec_t)
    assert t_an.soundfiledur == pytest.approx(2.5)
    t_an.shifts = j_an.shifts = 4
    hashes = t_an.wavfile2hashes(path)
    np.testing.assert_array_equal(hashes, t_an.hashes_batch(wave[None], shifts=4)[0])
    j_hashes = j_an.wavfile2hashes(path)
    common = len(set(map(tuple, hashes)) & set(map(tuple, j_hashes)))
    assert common >= 0.97 * max(len(hashes), len(j_hashes))
    ht = HashTable(depth=20)
    dur, n = t_an.ingest(ht, path)
    assert (dur, n) == (pytest.approx(2.5), len(hashes)) and ht.names == [path]
    np.testing.assert_array_equal(
        ht.retrieve(path)[np.lexsort(ht.retrieve(path).T)], hashes[np.lexsort(hashes.T)] & [0x3FFF, 0xFFFFF])


def test_sequential_accuracy_equals_batched_with_and_without_the_device_matcher(corpus):
    an1 = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    halve = lambda s: 0.5 * s  # a denoiser that leaves the peaks where they are
    an2 = AudfprintPeaks(afp_settings["audfprint"], denoising=True, denoising_model="unet",
                         spec_denoiser=halve, device="cpu")
    for a in (an1, an2):
        a.shifts = 4
    q, names = list(corpus["queries"]), corpus["query_names"]
    seq = texps.compute_accuracy(q, corpus["ht"], an1, an2, names=names, device="cpu")
    oracle = texps.compute_accuracy_batched(
        q, corpus["ht"], an1, an2, batch_size=5, use_device_matcher=False, names=names, device="cpu")
    fused = texps.compute_accuracy_batched(
        q, corpus["ht"], an1, an2, batch_size=5, names=names, device="cpu")
    assert list(seq) == ["No Denoising", "With Denoising", "Mix Pipeline"]
    assert seq == oracle == fused
    assert seq["No Denoising"] >= 0.75 and seq["With Denoising"] == seq["No Denoising"]
    # use_device_matcher=False does not consult a prebuilt device matcher
    other = DeviceMatcher(HashTable(depth=20), device="cpu")
    assert texps.compute_accuracy_batched(
        q, corpus["ht"], an1, batch_size=12, use_device_matcher=False, device_matcher=other,
        names=names, device="cpu") == {"No Denoising": seq["No Denoising"]}
    assert texps.compute_accuracy(q, corpus["ht"], an1, names=names, device="cpu") == {
        "No Denoising": seq["No Denoising"]}
    # the oracle's verdicts on the port's hashes are the JAX oracle's
    j_ht = JHashTable(depth=20)
    for name in corpus["ht"].names:
        j_ht.store(name, corpus["ht"].retrieve(name))
    hashes = an1.hashes_batch(corpus["queries"], shifts=4)
    assert [Matcher().hashes_match_to_msgs(corpus["ht"], h)[:2] for h in hashes] == [
        JMatcher().hashes_match_to_msgs(j_ht, h)[:2] for h in hashes]

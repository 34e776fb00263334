"""Query generation and identification from paths, port against JAX.

Small WAV tracks are written under ``tmp_path``; clean queries are cut by
both packages (equal pickles); the frozen-seed augmented set must not depend
on the batch size; the port's pickles are read by the JAX loader and its
``_load`` reads ``.pkl``, ``.wav`` and ``.npy``; the identification rate over
two condition directories is held against the JAX ``DeviceMatcher`` on the
same query files (equal verdict names; aligned counts within 5%, the FFTs of
the two packages rounding differently at ingest and at query time, which
moves the marginal peaks of a noisy query).
"""

import os
import pickle

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from musicfpaugment_torch import augment as taugment
from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.data import audio_io as taudio
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.testing import audfprint_exps as texps
from musicfpaugment_torch.testing import generate_queries as tgen
from musicfpaugment_torch.testing.parameters import afp_settings, test_pipelines_parameters
from musicfpaugment_tpu.afp.audfprint import AudfprintPeaks as JAudfprintPeaks
from musicfpaugment_tpu.afp.audfprint import DeviceMatcher as JDeviceMatcher
from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
from musicfpaugment_tpu.data import audio_io as jaudio
from musicfpaugment_tpu.testing import generate_queries as jgen
from musicfpaugment_tpu.testing.audfprint_exps import (
    create_fp_database as j_create_fp_database,
)

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
N_TRACKS = 16
CONDITIONS = ("bn_p10", "recording_device")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Sixteen 12-14 s tracks as 16-bit WAV files (two of them stereo at
    16 kHz), the clean queries cut from them, two augmented condition
    directories, and both packages' tables over the WAV files."""
    root = tmp_path_factory.mktemp("corpus")
    (root / "wav").mkdir()
    r = np.random.default_rng(0)
    files = []
    for i in range(N_TRACKS):
        sr = 16000 if i < 2 else SR
        w = next(synthetic_clean_batches(1, int(r.uniform(12, 14) * sr), seed=300 + i, sample_rate=sr))[0]
        data = (w / np.abs(w).max() * 30000).astype(np.int16)
        if i < 2:
            data = np.stack([data, data // 2], axis=1)
        path = str(root / "wav" / f"trk{i:02d}.wav")
        scipy.io.wavfile.write(path, sr, data)
        files.append(path)
    cleans = str(root / "queries" / "cleans")
    tgen.generate_clean_queries(files, cleans, save=True)
    nb, ib = taugment.synthetic_banks(
        sample_rate=SR, num_noise=8, num_irs=4, noise_row_length=9 * SR, seed=1, device="cpu")
    dirs = {"cleans": cleans}
    for cond in CONDITIONS:
        fp = taugment.AugmentFP(
            nb, SR, parameters=test_pipelines_parameters[cond],
            impulse_response_dir=ib, device="cpu")
        dirs[cond] = str(root / "queries" / cond)
        tgen.generate_augmented_queries(
            dirs[cond], test_pipelines_parameters[cond], save=True, augmenter=fp,
            cleans_path=cleans, batch_size=8)
    t_ht = texps.create_fp_database(files, None, hash_tab=HashTable(depth=20), device="cpu")
    j_ht = j_create_fp_database(files, None, hash_tab=JHashTable(depth=20))
    return {"root": root, "files": files, "dirs": dirs, "banks": (nb, ib), "t_ht": t_ht, "j_ht": j_ht}


def _pickles(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_audio_io_matches_jax(corpus):
    for path in corpus["files"][:3]:
        got, sr = taudio.read_wav(path)
        want, jsr = jaudio.read_wav(path)
        assert sr == jsr and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        assert taudio.wav_metadata(path) == tuple(jaudio.wav_metadata(path))
    x = np.random.default_rng(1).standard_normal(4000).astype(np.float32)
    np.testing.assert_array_equal(taudio.resample(x, 16000, SR), jaudio.resample(x, 16000, SR))
    assert taudio.resample(x, SR, SR) is x
    wav_dir = os.path.dirname(corpus["files"][0])
    assert taudio.find_audio_files_in_paths([wav_dir]) == jaudio.find_audio_files_in_paths([wav_dir])
    assert len(taudio.find_audio_files_in_paths([wav_dir, corpus["files"][0]])) == N_TRACKS + 1
    ta, ja = taudio.Audio(SR), jaudio.Audio(SR)
    assert ta.get_num_samples(corpus["files"][0]) == ja.get_num_samples(corpus["files"][0])
    np.testing.assert_array_equal(
        ta(corpus["files"][0], sample_offset=100, num_samples=5000),
        ja(corpus["files"][0], sample_offset=100, num_samples=5000))
    with pytest.raises(IOError, match="mp3"):
        taudio.read_wav("song.mp3")


def test_clean_queries_equal_jax(corpus, tmp_path):
    jgen.generate_clean_queries(corpus["files"], str(tmp_path / "jcleans"), save=True)
    got, want = _pickles(corpus["dirs"]["cleans"]), _pickles(tmp_path / "jcleans")
    assert list(got) == list(want) == [f"trk{i:02d}.pkl" for i in range(N_TRACKS)]
    for name in got:
        assert got[name].shape == (8 * SR,) and got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])
    # a missing file and a track shorter than the crop are reported, not fatal
    tgen.generate_clean_queries(
        [str(tmp_path / "none.wav"), corpus["files"][0]], str(tmp_path / "short"),
        duration=60, save=True)
    assert os.listdir(tmp_path / "short") == []


@pytest.mark.parametrize("cond", CONDITIONS)
def test_augmented_queries_ignore_batch_size(cond, corpus, tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see test_batch_augment_indexed_ignores_batch_size
    try:
        outs = []
        for bs in (8, 16, 3):
            fp = taugment.AugmentFP(
                corpus["banks"][0], SR, parameters=test_pipelines_parameters[cond],
                impulse_response_dir=corpus["banks"][1], device="cpu")
            out = str(tmp_path / f"bs{bs}")
            tgen.generate_augmented_queries(
                out, test_pipelines_parameters[cond], save=True, augmenter=fp,
                cleans_path=corpus["dirs"]["cleans"], batch_size=bs)
            outs.append(_pickles(out))
    finally:
        torch.set_num_threads(threads)
    cleans = _pickles(corpus["dirs"]["cleans"])
    assert list(outs[0]) == list(cleans)
    for name in outs[0]:
        a = outs[0][name]
        assert a.shape == (8 * SR,) and a.dtype == np.float32 and np.isfinite(a).all()
        assert abs(np.abs(a).max() - 1.0) <= 1e-6
        assert not np.array_equal(a, cleans[name] / np.abs(cleans[name]).max())
        # bit-identical for batch sizes that are multiples of 8; for others
        # the CPU's vector units round a tensor's odd rows differently
        np.testing.assert_array_equal(a, outs[1][name])
        np.testing.assert_allclose(a, outs[2][name], rtol=0, atol=1e-6)


def test_generated_pickles_load_in_both_packages(corpus):
    t_an = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    j_an = JAudfprintPeaks(afp_settings["audfprint"])
    for cond in ("cleans",) + CONDITIONS:
        path = os.path.join(corpus["dirs"][cond], "trk03.pkl")
        got = t_an._load(path)
        assert got.shape == (8 * SR,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, j_an._load(path))


def test_load_reads_wav_npy_arrays_and_names_its_suffixes(corpus, tmp_path):
    t_an = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    j_an = JAudfprintPeaks(afp_settings["audfprint"])
    for path in corpus["files"][:3]:  # stereo 16 kHz and mono 8 kHz
        got = t_an._load(path)
        assert got.ndim == 1 and got.dtype == np.float32
        np.testing.assert_array_equal(got, j_an._load(path))
    np.save(tmp_path / "a.npy", np.arange(6, dtype=np.float64).reshape(2, 3))
    np.testing.assert_array_equal(t_an._load(str(tmp_path / "a.npy")), np.arange(6, dtype=np.float32))
    assert t_an._load(np.ones((1, 4))).shape == (4,)
    assert t_an._load(torch.ones(1, 4, dtype=torch.float64)).dtype == torch.float32
    with pytest.raises(ValueError, match=r"\.npy, \.pkl and \.wav"):
        t_an._load(str(tmp_path / "song.flac"))


def test_identification_rate_matches_jax_matcher(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(texps, "RESULTS_DIR", str(tmp_path / "results"))
    results = texps.identification_rate_results(
        query_paths=corpus["dirs"], dbpath=corpus["t_ht"], batch_size=4, device="cpu")
    assert list(results) == ["cleans", *CONDITIONS]
    assert all(set(v) == {"No Denoising"} for v in results.values())
    assert results["cleans"]["No Denoising"] == 1.0
    assert os.path.isfile(tmp_path / "results" / "accuracy_audfprint_none.json")
    # the JAX matcher over the JAX table on the same query files
    t_an = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    t_dm = DeviceMatcher(corpus["t_ht"], device="cpu")
    j_dm = JDeviceMatcher(corpus["j_ht"])
    for cond, path in corpus["dirs"].items():
        names = sorted(os.listdir(path))
        wavs = np.stack([t_an._load(os.path.join(path, n)) for n in names])
        got = t_dm.match_waveforms(wavs, shifts=4)
        want = j_dm.match_waveforms(wavs, shifts=4)
        assert [g[:2] for g in got] == [w[:2] for w in want], cond
        for g, w in zip(got, want):
            assert abs(g[2] - w[2]) <= max(2, 0.05 * w[2]), (cond, g, w)
        right = sum(
            g[0] == "MATCH" and os.path.basename(g[1]).split(".")[0] == n.split(".")[0]
            for g, n in zip(got, names))
        assert right / len(names) == results[cond]["No Denoising"], cond
    assert results["bn_p10"]["No Denoising"] >= 0.9


def test_identification_rate_raises_for_a_denoiser_and_defaults_to_the_card(corpus, tmp_path, monkeypatch):
    """With a denoising model the three accuracies come back for every
    condition; a denoiser without its model's name raises; no device means
    the card."""
    monkeypatch.setattr(texps, "RESULTS_DIR", str(tmp_path / "results"))
    results = texps.identification_rate_results(
        "unet", spec_denoiser=lambda sgram: sgram, query_paths=corpus["dirs"],
        dbpath=corpus["t_ht"], batch_size=8, device="cpu")
    assert list(results) == ["cleans", *CONDITIONS]
    for row in results.values():
        assert list(row) == ["No Denoising", "With Denoising", "Mix Pipeline"]
        # a denoiser that returns its input: the three arms agree
        assert row["With Denoising"] == row["Mix Pipeline"] == row["No Denoising"]
    assert results["cleans"]["No Denoising"] == 1.0
    assert os.path.isfile(tmp_path / "results" / "accuracy_audfprint_unet.json")
    for kw in ({"spec_denoiser": object()}, {"wave_denoiser": object()}):
        with pytest.raises(ValueError, match="needs its denoising_model"):
            texps.identification_rate_results(
                query_paths=corpus["dirs"], dbpath=corpus["t_ht"], device="cpu", **kw)
    with pytest.raises(ValueError, match="requires spec_denoiser"):
        texps.identification_rate_results(
            "unet", query_paths=corpus["dirs"], dbpath=corpus["t_ht"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            texps.identification_rate_results(query_paths=corpus["dirs"], dbpath=corpus["t_ht"])


def test_generate_queries_main_rejects_the_unported_selection(monkeypatch):
    monkeypatch.setattr("sys.argv", ["generate_queries", "--queries", "cleans"])
    with pytest.raises(NotImplementedError, match="fma_preprocessing"):
        tgen.main()

"""Denoised identification and peak metrics with a Demucs waveform denoiser,
port against the JAX package's batched device path (CPU,
``Demucs(hidden=8, depth=3)`` on the same weights).

An untrained Demucs leaves no music, so both hooks add 0.3 of the network's
output to their input: the peaks survive and the network still moves them.
Limits are those of the UNet hook: verdicts and track ids equal, scores
within max(2, 5%), peak masks equal in >= 0.999 of cells, the three
accuracies equal; the eight peak metrics within 1e-3.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch import convert
from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.afp.audfprint import peaks as tp
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.testing import audfprint_exps as texps
from musicfpaugment_torch.testing.parameters import afp_settings
from musicfpaugment_tpu.afp.audfprint import AudfprintPeaks as JAudfprintPeaks
from musicfpaugment_tpu.afp.audfprint import DeviceMatcher as JDeviceMatcher
from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
from musicfpaugment_tpu.afp.audfprint import peaks as jp
from musicfpaugment_tpu.models import Demucs as JDemucs
from musicfpaugment_tpu.testing import audfprint_exps as jexps

from torch_port_helpers import few_threads, flax_demucs_params, port_demucs  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
N = 6
MIX = 0.3


@pytest.fixture(scope="module")
def hooks():
    jm = JDemucs(hidden=8, depth=3)
    params = flax_demucs_params(jm, length=3 * SR, seed=17)
    forward = jax.jit(lambda w: jm.apply({"params": params}, w))
    t_demucs = convert.demucs_denoiser(port_demucs(params))
    return (lambda w: w + MIX * forward(jnp.asarray(w, jnp.float32)),
            lambda w: w + MIX * t_demucs(w))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six 10 s tracks indexed by both packages; 3 s crops of them, clean
    and noisy, as ``.pkl`` files named after their track; the clean crops
    also under the names the peak metrics pair them by."""
    root = tmp_path_factory.mktemp("demucs_queries")
    tracks = next(synthetic_clean_batches(N, 10 * SR, seed=61, sample_rate=SR))
    names = [f"corpus/q{i}.wav" for i in range(N)]
    t_ht, j_ht = HashTable(depth=20), JHashTable(depth=20)
    AudfprintPeaks(afp_settings["audfprint"], device="cpu").ingest_batch(t_ht, names, tracks)
    JAudfprintPeaks(afp_settings["audfprint"]).ingest_batch(j_ht, names, tracks)
    crops = np.stack([t[2 * SR + 300 * i :][: 3 * SR] for i, t in enumerate(tracks)])
    noisy = crops + 0.2 * crops.std() * np.random.default_rng(9).standard_normal(crops.shape)
    sets = {"cleans": crops, "noisy": noisy.astype(np.float32)}
    files = {}
    for name, waves in sets.items():
        os.makedirs(root / name)
        files[name] = []
        for i, w in enumerate(waves):
            files[name].append(str(root / name / f"q{i}.pkl"))
            with open(files[name][-1], "wb") as f:
                pickle.dump(np.asarray(w, np.float32), f)
    return {"tables": (t_ht, j_ht), "sets": sets, "files": files, "cleans": str(root / "cleans")}


def _analyzers(hooks):
    params = afp_settings["audfprint"]
    j_hook, t_hook = hooks
    return (
        AudfprintPeaks(params, device="cpu"),
        AudfprintPeaks(params, denoising=True, denoising_model="demucs", wave_denoiser=t_hook, device="cpu"),
        JAudfprintPeaks(params),
        JAudfprintPeaks(params, denoising=True, denoising_model="demucs", wave_denoiser=j_hook),
    )


def test_denoised_verdicts_and_masks_match_jax(hooks, corpus):
    j_hook, t_hook = hooks
    t_ht, j_ht = corpus["tables"]
    x = corpus["sets"]["noisy"]
    t_den, j_den = t_hook(torch.from_numpy(x)), np.asarray(j_hook(x))
    got = DeviceMatcher(t_ht, device="cpu").match_waveforms(t_den, shifts=4)
    want = JDeviceMatcher(j_ht).match_waveforms(j_den, shifts=4)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert sum(g[0] == "MATCH" for g in got) >= N - 1
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= max(2, 0.05 * w[2]), (g, w)
    masks = tp.find_peaks_batch(t_den).numpy()
    j_masks = np.asarray(jp.find_peaks_batch(jnp.asarray(j_den)))
    assert masks.shape == j_masks.shape and (masks == j_masks).mean() >= 0.999
    plain = tp.find_peaks_batch(torch.from_numpy(x)).numpy()
    assert (masks != plain).any()  # the network moved the peaks


def test_denoised_accuracies_match_jax_with_the_hook_applied_once_per_batch(hooks, corpus):
    t_no, t_den, j_no, j_den = _analyzers(hooks)
    seen = []
    hook = t_den.wave_denoiser

    def counted(w):
        seen.append(tuple(w.shape))
        return hook(w)

    t_den.wave_denoiser = counted
    t_ht, j_ht = corpus["tables"]
    for name, files in corpus["files"].items():
        seen.clear()
        got = texps.compute_accuracy_batched(files, t_ht, t_no, t_den, batch_size=4, shifts=4, device="cpu")
        want = jexps.compute_accuracy_batched(files, j_ht, j_no, j_den, batch_size=4, shifts=4)
        assert got == want, name
        assert list(got) == ["No Denoising", "With Denoising", "Mix Pipeline"]
        assert seen == [(4, 3 * SR), (2, 3 * SR)], name
    assert got["No Denoising"] >= 5 / 6


def test_denoised_peak_metrics_match_jax(hooks, corpus):
    t_no, t_den, j_no, j_den = _analyzers(hooks)
    queries, cleans = corpus["files"]["noisy"], corpus["cleans"]
    got = texps.compute_peaks_metrics_batched(queries, t_no, t_den, cleans_path=cleans, batch_size=4)
    want = jexps.compute_peaks_metrics_batched(queries, j_no, j_den, cleans_path=cleans, batch_size=4)
    assert list(got) == list(texps.PEAKS_METRICS) and len(got) == 8
    for key, v in want.items():
        assert np.isfinite(got[key]) and abs(got[key] - v) <= 1e-3, (key, got[key], v)
    assert got["f1_den"] != got["f1_score_no_den"]

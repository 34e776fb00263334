"""The peak-metrics and denoiser arms of the evaluation harness, port
against JAX with the same UNet weights on small WAV and pickle files.

Sequential against batched: equal to 1e-6 (the same per-example numbers,
summed in another order). Against JAX: P/R/F1 within 0.01 (the FFTs of the
two packages move marginal peaks), PSNR within 1e-3 dB.
"""

import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from musicfpaugment_torch import convert
from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, HashTable
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.testing import audfprint_exps as texps
from musicfpaugment_torch.testing.parameters import afp_settings
from musicfpaugment_tpu.afp.audfprint import AudfprintPeaks as JAudfprintPeaks
from musicfpaugment_tpu.models import UNet as JUNet
from musicfpaugment_tpu.testing import audfprint_exps as jexps

from torch_port_helpers import few_threads, flax_unet_variables, port_unet  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
N = 6


@pytest.fixture(scope="module")
def hooks():
    """One UNet (base=8) as the JAX hook and as the port's, letting the
    network move every bin by up to 20% so that the peaks survive."""
    jm = JUNet(1, 1, base=8)
    params, stats = flax_unet_variables(jm, (1, 16, 16), seed=31)
    variables = {"params": params, "batch_stats": stats}
    t_unet = convert.unet_denoiser(port_unet(params, stats))
    j_hook = lambda s: s * (1.0 + 0.2 * jnp.tanh(jm.apply(variables, s, train=False)))
    t_hook = lambda s: s * (1.0 + 0.2 * torch.tanh(t_unet(s)))
    return j_hook, t_hook


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Six 2.5 s clean queries and two degraded sets (noise; noise and a
    gain), as ``.pkl`` at the generator's rate, and the clean set also as
    16-bit WAV, the clean and the noisy set, file 2 of both a second longer than
    the others."""
    root = tmp_path_factory.mktemp("queries")
    clean = next(synthetic_clean_batches(N, 5 * SR // 2, seed=51, sample_rate=SR))
    rng = np.random.default_rng(8)
    noisy = clean + 0.3 * clean.std() * rng.standard_normal(clean.shape).astype(np.float32)
    sets = {"cleans": clean, "noisy": noisy, "quiet": 0.25 * noisy}
    dirs = {}
    for name, waves in sets.items():
        dirs[name] = str(root / name)
        os.makedirs(dirs[name])
        for i, w in enumerate(waves):
            with open(os.path.join(dirs[name], f"q{i}.pkl"), "wb") as f:
                pickle.dump(np.asarray(w, np.float32), f)
    wav_dir = str(root / "wav")
    os.makedirs(os.path.join(wav_dir, "cleans"))
    os.makedirs(os.path.join(wav_dir, "noisy"))
    for i in range(N):
        for name in ("cleans", "noisy"):
            w = sets[name][i] if i != 2 else np.concatenate([sets[name][i], sets[name][i][:SR]])
            scipy.io.wavfile.write(
                os.path.join(wav_dir, name, f"q{i}.wav"), SR,
                (w / np.abs(sets[name]).max() * 30000).astype(np.int16))
    return {"dirs": dirs, "wav": wav_dir, "sets": sets}


def _analyzers(t_hook, j_hook):
    params = afp_settings["audfprint"]
    return (
        AudfprintPeaks(params, device="cpu"),
        AudfprintPeaks(params, denoising=True, denoising_model="unet", spec_denoiser=t_hook, device="cpu"),
        JAudfprintPeaks(params),
        JAudfprintPeaks(params, denoising=True, denoising_model="unet", spec_denoiser=j_hook),
    )


def _listed(directory):
    return [os.path.join(directory, n) for n in sorted(os.listdir(directory))]


@pytest.mark.parametrize("kind", ["pkl", "wav"])
def test_peaks_metrics_sequential_batched_and_jax_agree(hooks, files, kind):
    t_no, t_den, j_no, j_den = _analyzers(hooks[1], hooks[0])
    if kind == "pkl":
        queries, cleans = _listed(files["dirs"]["noisy"]), files["dirs"]["cleans"]
    else:  # mixed lengths: two groups in the batched path
        queries, cleans = _listed(os.path.join(files["wav"], "noisy")), os.path.join(files["wav"], "cleans")
    seq = texps.compute_peaks_metrics(queries, t_no, t_den, cleans_path=cleans)
    bat = texps.compute_peaks_metrics_batched(queries, t_no, t_den, cleans_path=cleans, batch_size=4)
    assert list(seq) == list(bat) == list(texps.PEAKS_METRICS) and len(seq) == 8
    for key in seq:
        assert np.isfinite(seq[key]) and abs(seq[key] - bat[key]) <= 1e-6, key
    want = jexps.compute_peaks_metrics_batched(queries, j_no, j_den, cleans_path=cleans, batch_size=4)
    for key in seq:
        limit = 1e-3 if key.startswith("psnr") else 0.01
        assert abs(bat[key] - want[key]) <= limit, (key, bat[key], want[key])
    assert 0.2 < bat["f1_score_no_den"] < 1.0 and 0.2 < bat["f1_den"] < 1.0
    assert bat["f1_den"] != bat["f1_score_no_den"] and bat["psnr_den_spec"] != bat["psnr_no_den_spec"]


def test_peaks_metrics_of_a_set_against_itself_are_perfect(hooks, files):
    t_no, _, _, _ = _analyzers(hooks[1], hooks[0])
    same = AudfprintPeaks(afp_settings["audfprint"], denoising=True, denoising_model="unet",
                          spec_denoiser=lambda s: s, device="cpu")
    got = texps.compute_peaks_metrics_batched(
        _listed(files["dirs"]["cleans"]), t_no, same, cleans_path=files["dirs"]["cleans"])
    for key in ("precision_no_den", "recall_no_den", "f1_score_no_den", "prec_den", "rec_den", "f1_den"):
        assert got[key] == 1.0
    assert got["psnr_no_den_spec"] > 100 and got["psnr_den_spec"] == got["psnr_no_den_spec"]
    # a file that does not load is reported and left out of the means
    missing = _listed(files["dirs"]["cleans"]) + [os.path.join(files["dirs"]["cleans"], "none.pkl")]
    assert texps.compute_peaks_metrics_batched(
        missing, t_no, same, cleans_path=files["dirs"]["cleans"]) == got


def test_peaks_metrics_results_writes_every_condition_but_cleans(hooks, files, tmp_path, monkeypatch):
    monkeypatch.setattr(texps, "RESULTS_DIR", str(tmp_path / "results"))
    got = texps.peaks_metrics_results(
        "unet", spec_denoiser=hooks[1], query_paths=files["dirs"], device="cpu")
    assert list(got) == ["noisy", "quiet"]
    for row in got.values():
        assert list(row) == list(texps.PEAKS_METRICS) and all(np.isfinite(v) for v in row.values())
    # the frontend normalises each query by its own maximum: a gain changes nothing
    for key in texps.PEAKS_METRICS:
        assert abs(got["noisy"][key] - got["quiet"][key]) <= 1e-4
    with open(tmp_path / "results" / "peaks_metrics_audfprint_unet.json") as f:
        assert json.load(f) == got
    seq = texps.peaks_metrics_results(
        "unet", spec_denoiser=hooks[1], query_paths={k: files["dirs"][k] for k in ("cleans", "noisy")},
        batched=False, device="cpu")
    for key in texps.PEAKS_METRICS:
        assert abs(seq["noisy"][key] - got["noisy"][key]) <= 1e-6
    with pytest.raises(ValueError, match="requires spec_denoiser"):
        texps.peaks_metrics_results("unet", query_paths=files["dirs"], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            texps.peaks_metrics_results("unet", spec_denoiser=hooks[1], query_paths=files["dirs"])


@pytest.fixture(scope="module")
def table(files):
    ht = HashTable(depth=20)
    analyzer = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    tracks = next(synthetic_clean_batches(N, 5 * SR // 2, seed=51, sample_rate=SR))
    analyzer.ingest_batch(ht, [f"corpus/q{i}.wav" for i in range(N)], tracks)
    return ht


@pytest.mark.parametrize("batched", [True, False])
def test_identification_rate_with_a_denoiser_has_three_keys_per_condition(
        hooks, files, table, tmp_path, monkeypatch, batched):
    monkeypatch.setattr(texps, "RESULTS_DIR", str(tmp_path / "results"))
    got = texps.identification_rate_results(
        "unet", spec_denoiser=hooks[1], query_paths=files["dirs"], dbpath=table,
        batched=batched, batch_size=4, device="cpu")
    assert list(got) == ["cleans", "noisy", "quiet"]
    for cond, row in got.items():
        assert list(row) == ["No Denoising", "With Denoising", "Mix Pipeline"], cond
        assert all(0.0 <= v <= 1.0 for v in row.values())
        assert row["Mix Pipeline"] >= min(row["No Denoising"], row["With Denoising"])
    assert got["cleans"]["No Denoising"] == 1.0 and got["cleans"]["With Denoising"] >= 0.8
    with open(tmp_path / "results" / "accuracy_audfprint_unet.json") as f:
        assert json.load(f) == got


def test_identification_rate_with_a_waveform_denoiser(files, table, tmp_path, monkeypatch):
    monkeypatch.setattr(texps, "RESULTS_DIR", str(tmp_path / "results"))
    seen = []

    def silence(w):  # a waveform denoiser that removes everything
        seen.append(tuple(w.shape))
        return torch.zeros_like(w)

    got = texps.identification_rate_results(
        "demucs", wave_denoiser=silence, query_paths={"cleans": files["dirs"]["cleans"]},
        dbpath=table, batch_size=4, device="cpu")
    assert got == {"cleans": {"No Denoising": 1.0, "With Denoising": 0.0, "Mix Pipeline": 1.0}}
    assert seen == [(4, 20000), (2, 20000)]  # once per batch, before the shifts
    assert os.path.isfile(tmp_path / "results" / "accuracy_audfprint_demucs.json")
    with pytest.raises(ValueError, match="needs its denoising_model"):
        texps.identification_rate_results(
            wave_denoiser=silence, query_paths=files["dirs"], dbpath=table, device="cpu")


@pytest.mark.parametrize("action,error,match", [
    ("index", FileNotFoundError, "fma_large_preprocessed.csv"),
    ("identification_rate", ValueError, "requires spec_denoiser"),
    ("peaks_metrics", ValueError, "requires spec_denoiser"),
])
def test_main_actions(monkeypatch, tmp_path, action, error, match):
    """``index`` reads the FMA selection, absent from an empty dataset
    directory; the other two actions build a UNet analyzer without a
    denoiser, as the JAX CLI does, and the analyzer refuses it (on a machine
    without a card the device check comes first)."""
    monkeypatch.setattr("sys.argv", ["audfprint_exps", "--action", action, "--model", "unet"])
    monkeypatch.setenv("MFPA_DATASET_DIR", str(tmp_path))
    if action != "index" and not torch.cuda.is_available():
        error, match = RuntimeError, "device='cpu'"
    with pytest.raises(error, match=match):
        texps.main()

"""The Dejavu evaluation harness, port against the JAX package on the same
files (CPU): the per-file and the batched accuracies, the per-file and the
batched peak metrics with a UNet arm (``UNet(base=8)``) and a Demucs arm
(``Demucs(hidden=8, depth=3)``), the same seeded weights on both sides, and
the two ``*_results`` functions writing their JSON.

Accuracies equal; peak metrics within 1e-5 of JAX's; each batched path
equal to the port's own per-file path within 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from musicfpaugment_torch import convert
from musicfpaugment_torch.afp.dejavu import Dejavu, DejavuDeviceIndex, DejavuDeviceMatcher, read
from musicfpaugment_torch.afp.dejavu.sqlite_database import SQLiteDatabase
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.testing import dejavu_exps as texps
from musicfpaugment_torch.testing.parameters import afp_db_paths, afp_settings
from musicfpaugment_tpu.afp import dejavu as JD
from musicfpaugment_tpu.afp.dejavu.sqlite_database import SQLiteDatabase as JSQLiteDatabase
from musicfpaugment_tpu.models import Demucs as JDemucs
from musicfpaugment_tpu.models import UNet as JUNet
from musicfpaugment_tpu.testing import dejavu_exps as jexps
from musicfpaugment_tpu.testing import parameters as jparams

from torch_port_helpers import (  # noqa: F401
    few_threads,
    flax_demucs_params,
    flax_unet_variables,
    port_demucs,
    port_unet,
)

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
N = 5
MIX = 0.3
QUERY_SECONDS = 3


@pytest.fixture(scope="module")
def hooks():
    """(JAX, port) spectrogram hooks of one seeded UNet and waveform hooks of
    one seeded Demucs (which adds 0.3 of its output to its input, so that
    an untrained network keeps the music and still moves the peaks)."""
    ju = JUNet(1, 1, base=8)
    params, stats = flax_unet_variables(ju, (1, 16, 16), seed=14)
    variables = {"params": params, "batch_stats": stats}
    j_unet = lambda s: ju.apply(variables, s, train=False).astype(jnp.float32)  # noqa: E731
    t_unet = convert.unet_denoiser(port_unet(params, stats))
    jd = JDemucs(hidden=8, depth=3)
    d_params = flax_demucs_params(jd, length=QUERY_SECONDS * SR, seed=18)
    forward = jax.jit(lambda w: jd.apply({"params": d_params}, w))
    t_demucs = convert.demucs_denoiser(port_demucs(d_params))
    j_demucs = lambda w: w + MIX * forward(jnp.asarray(w, jnp.float32))  # noqa: E731
    return {"unet": (j_unet, t_unet), "demucs": (j_demucs, lambda w: w + MIX * t_demucs(w))}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five 8 s tracks as wav files, indexed by both packages over SQLite;
    3 s crops of each as ``cleans/track_i.npy`` and noisy versions under the
    same names in ``noisy/``."""
    root = tmp_path_factory.mktemp("dejavu_exps")
    tracks = next(synthetic_clean_batches(N, 8 * SR, seed=81, sample_rate=SR))
    os.makedirs(root / "tracks")
    paths = []
    for i, x in enumerate(tracks):
        paths.append(str(root / "tracks" / f"track_{i}.wav"))
        scipy.io.wavfile.write(paths[-1], SR, (x * 32000).astype(np.int16))
    rng = np.random.default_rng(82)
    crops = np.stack([x[SR * (1 + i // 2) :][: QUERY_SECONDS * SR] for i, x in enumerate(tracks)])
    noisy = crops + 0.3 * crops.std() * rng.standard_normal(crops.shape)
    dirs = {}
    for name, waves in (("cleans", crops), ("noisy", noisy)):
        os.makedirs(root / name)
        dirs[name] = str(root / name)
        for i, w in enumerate(waves):
            np.save(root / name / f"track_{i}.npy", w.astype(np.float32))
    t_db, j_db = SQLiteDatabase(":memory:"), JSQLiteDatabase(":memory:")
    texps.create_fp_database(paths, Dejavu({}, db=t_db, device="cpu"))
    jexps.create_fp_database(paths, JD.Dejavu({}, db=j_db))
    return {"paths": paths, "dirs": dirs, "dbs": (t_db, j_db)}


def _files(corpus, name):
    d = corpus["dirs"][name]
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


def _engines(corpus, hooks, model):
    """(port no-denoise, port denoise, JAX no-denoise, JAX denoise)."""
    t_db, j_db = corpus["dbs"]
    j_hook, t_hook = hooks[model]
    key = "spec_denoiser" if model == "unet" else "wave_denoiser"
    st = afp_settings["dejavu"]
    return (
        Dejavu({}, st, db=t_db, device="cpu"),
        Dejavu({}, st, db=t_db, denoising=True, denoising_model=model, device="cpu", **{key: t_hook}),
        JD.Dejavu({}, st, db=j_db),
        JD.Dejavu({}, st, db=j_db, denoising=True, denoising_model=model, **{key: j_hook}),
    )


def test_indexes_are_the_same(corpus):
    t_db, j_db = corpus["dbs"]
    assert t_db.get_songs() == j_db.get_songs()
    assert sorted(t_db.get_iterable_kv_pairs()) == sorted(j_db.get_iterable_kv_pairs())
    assert [s["song_name"] for s in t_db.get_songs()] == [f"track_{i}" for i in range(N)]


@pytest.mark.parametrize("model", ["unet", "demucs"])
def test_compute_accuracy_matches_jax(corpus, hooks, model):
    t_no, t_den, j_no, j_den = _engines(corpus, hooks, model)
    for name in ("cleans", "noisy"):
        files = _files(corpus, name)
        got = texps.compute_accuracy(files, t_no, t_den)
        assert got == jexps.compute_accuracy(files, j_no, j_den), (model, name)
        assert list(got) == ["No Denoising", "With Denoising", "Mix Pipeline"]
    assert got["No Denoising"] >= (N - 1) / N


def test_compute_accuracy_batched_matches_per_file_and_jax(corpus, hooks):
    """The UNet arm through two device matchers equals the per-file path
    (and JAX's batched path) on the same files."""
    j_hook, t_hook = hooks["unet"]
    names = [f"track_{i}" for i in range(N)]
    waves = np.stack([read(p)[0][0] for p in corpus["paths"]])
    t_idx, j_idx = DejavuDeviceIndex(), JD.DejavuDeviceIndex()
    t_idx.ingest_arrays(names, waves, device="cpu")
    j_idx.ingest_arrays(names, waves)
    t_m = (DejavuDeviceMatcher(t_idx, device="cpu"), DejavuDeviceMatcher(t_idx, spec_denoiser=t_hook, device="cpu"))
    j_m = (JD.DejavuDeviceMatcher(j_idx), JD.DejavuDeviceMatcher(j_idx, spec_denoiser=j_hook))
    t_no, t_den, _, _ = _engines(corpus, hooks, "unet")
    for name in ("cleans", "noisy"):
        files = _files(corpus, name)
        got = texps.compute_accuracy_batched(files, *t_m, batch_size=3)
        assert got == jexps.compute_accuracy_batched(files, *j_m, batch_size=3), name
        assert got == texps.compute_accuracy(files, t_no, t_den), name
    with pytest.raises(ValueError, match="uniform query lengths"):
        texps.compute_accuracy_batched(_files(corpus, "cleans")[:2] + corpus["paths"][:1], *t_m)


def _close(got, want, tol=1e-5):
    assert set(got) == set(want) == set(texps.PEAKS_METRICS)
    for k in want:
        assert abs(got[k] - want[k]) <= tol * max(1.0, abs(want[k])), (k, got[k], want[k])


@pytest.mark.parametrize("model", ["unet", "demucs"])
def test_peaks_metrics_match_jax(corpus, hooks, model):
    t_no, t_den, j_no, j_den = _engines(corpus, hooks, model)
    queries, cleans = _files(corpus, "noisy"), corpus["dirs"]["cleans"]
    per_file = texps.compute_peaks_metrics(queries, t_no, t_den, cleans_path=cleans)
    _close(per_file, jexps.compute_peaks_metrics(queries, j_no, j_den, cleans_path=cleans))
    batched = texps.compute_peaks_metrics_batched(queries, t_no, t_den, cleans_path=cleans, batch_size=2)
    _close(batched, jexps.compute_peaks_metrics_batched(queries, j_no, j_den, cleans_path=cleans,
                                                        batch_size=2))
    _close(batched, per_file)
    assert per_file["psnr_den_spec"] != per_file["psnr_no_den_spec"]  # the arm did something
    few = texps.compute_peaks_metrics_batched(queries, t_no, t_den, cleans_path=cleans, max_queries=2)
    _close(few, texps.compute_peaks_metrics(queries[:2], t_no, t_den, cleans_path=cleans))


def test_results_functions_write_their_json(corpus, hooks, tmp_path, monkeypatch):
    t_db, j_db = corpus["dbs"]
    j_hook, t_hook = hooks["unet"]
    monkeypatch.setattr(texps, "RESULTS_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jexps, "RESULTS_DIR", str(tmp_path / "jax"))
    qp = corpus["dirs"]
    got = texps.identification_rate_results("unet", spec_denoiser=t_hook, query_paths=qp, db=t_db,
                                            device="cpu")
    want = jexps.identification_rate_results("unet", spec_denoiser=j_hook, query_paths=qp, db=j_db)
    assert got == want and list(got) == ["cleans", "noisy"]
    with open(tmp_path / "port" / "accuracy_dejavu_unet.json") as f:
        assert json.load(f) == got
    got = texps.peaks_metrics_results("unet", spec_denoiser=t_hook, query_paths=qp, db=t_db,
                                      device="cpu")
    want = jexps.peaks_metrics_results("unet", spec_denoiser=j_hook, query_paths=qp, db=j_db)
    assert list(got) == ["noisy"]
    _close(got["noisy"], want["noisy"])
    with open(tmp_path / "port" / "peaks_metrics_dejavu_unet.json") as f:
        assert json.load(f) == got
    sequential = texps.peaks_metrics_results("unet", spec_denoiser=t_hook, query_paths=qp, db=t_db,
                                             batched=False, device="cpu")
    _close(sequential["noisy"], got["noisy"])


def test_settings_cli_and_defaults(monkeypatch, tmp_path):
    assert afp_settings["dejavu"] == jparams.afp_settings["dejavu"]
    assert afp_db_paths["dejavu"] == jparams.afp_db_paths["dejavu"]
    monkeypatch.setattr("sys.argv", ["dejavu_exps", "--action", "index"])
    monkeypatch.setenv("MFPA_DATASET_DIR", str(tmp_path))  # no FMA selection there
    with pytest.raises(FileNotFoundError, match="fma_large_preprocessed.csv"):
        texps.main()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            texps.create_fp_database([])

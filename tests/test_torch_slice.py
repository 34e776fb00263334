"""The audfprint identification slice end to end, port against JAX.

Synthetic 10-20 s tracks (numpy, from a seed) are written as .npy files and
indexed by both packages' ``create_fp_database`` (mixed lengths: padded
batches with validity masks). Clean and noisy 8 s crops then go through
both packages' ``match_waveforms`` at 4 shifts. The FFTs of the two
packages round differently at ~1e-6 (see test_torch_peaks.py), which can
move a peak and so a hash: verdict names must be equal, aligned counts
within +-2.

Also here: the device rule of the entry points, and an import scan that
keeps JAX and the JAX package out of the port.
"""

import ast
import os

import numpy as np
import pytest
import torch

from musicfpaugment_tpu.afp.audfprint import DeviceMatcher as JDeviceMatcher
from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
from musicfpaugment_tpu.testing.audfprint_exps import (
    create_fp_database as j_create_fp_database,
)
from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.data.synthetic import synth_tracks_device, synthetic_clean_batches
from musicfpaugment_torch.testing.audfprint_exps import (
    compute_accuracy_batched,
    create_fp_database,
)
from musicfpaugment_torch.testing.parameters import afp_settings

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
DEPTH = 20
COUNT_SLACK = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _track(i, seconds):
    return next(synthetic_clean_batches(1, int(seconds * SR), seed=100 + i))[0]


@pytest.fixture(scope="module")
def slice_state(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracks")
    r = np.random.default_rng(0)
    tracks, files = [], []
    for i in range(12):
        w = _track(i, r.uniform(10, 20))
        path = str(d / f"trk{i:02d}.npy")
        np.save(path, w)
        tracks.append(w)
        files.append(path)
    t_ht = create_fp_database(files, None, hash_tab=HashTable(depth=DEPTH), device="cpu")
    j_ht = j_create_fp_database(files, None, hash_tab=JHashTable(depth=DEPTH))
    crops, truth = [], []
    for q in range(16):
        ti = q % 12
        off = int(r.integers(0, len(tracks[ti]) - 8 * SR))
        crop = tracks[ti][off : off + 8 * SR].copy()
        if q % 2:  # noisy: white noise at 5 dB SNR
            noise = r.standard_normal(crop.shape).astype(np.float32)
            noise *= np.sqrt(np.mean(crop**2) / np.mean(noise**2) / 10 ** 0.5)
            crop = crop + noise
        crops.append(crop)
        truth.append(files[ti])
    return t_ht, j_ht, np.stack(crops), truth


def test_ingest_matches_jax(slice_state):
    t_ht, j_ht, _, _ = slice_state
    assert t_ht.names == j_ht.names
    t_hpi = np.asarray(t_ht.hashesperid, np.int64)
    j_hpi = np.asarray(j_ht.hashesperid, np.int64)
    assert (t_hpi > 200).all()
    # waveform-derived hashes: FFT rounding may move a few peaks
    assert np.abs(t_hpi - j_hpi).max() <= 0.01 * j_hpi.max()


def test_match_waveforms_matches_jax(slice_state):
    t_ht, j_ht, crops, truth = slice_state
    got = DeviceMatcher(t_ht, device="cpu").match_waveforms(crops, shifts=4)
    want = JDeviceMatcher(j_ht).match_waveforms(crops, shifts=4)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= COUNT_SLACK, (g, w)
    assert [g[1] for g in got[::2]] == truth[::2]  # every clean crop found
    assert sum(g[1] == t for g, t in zip(got, truth)) >= 14


def test_compute_accuracy_batched_mix_rule(slice_state):
    t_ht, _, crops, truth = slice_state
    a1 = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    a2 = AudfprintPeaks(dict(afp_settings["audfprint"], density=10), device="cpu")
    acc = compute_accuracy_batched(
        list(crops[::2]), t_ht, a1, a2, names=truth[::2], device="cpu"
    )
    assert acc["No Denoising"] == 1.0
    assert set(acc) == {"No Denoising", "With Denoising", "Mix Pipeline"}
    assert acc["Mix Pipeline"] == 1.0


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    ht = HashTable(depth=1, hashbits=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AudfprintPeaks(afp_settings["audfprint"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceMatcher(ht)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_fp_database([], None)
    a = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_accuracy_batched([], ht, a)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth_tracks_device(0, [0], SR)


def test_synth_tracks_device_deterministic_and_batch_invariant():
    a = synth_tracks_device(7, [3, 4, 5], 3 * SR, device="cpu")
    b = synth_tracks_device(7, [5, 4], 3 * SR, device="cpu")
    assert a.shape == (3, 3 * SR) and torch.isfinite(a).all()
    assert torch.equal(a[2], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1])
    assert float(a.abs().amax()) == 1.0


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_or_jax_package():
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "musicfpaugment_tpu"}
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(os.path.join(ROOT, "musicfpaugment_torch")):
        paths += [os.path.join(dirpath, f) for f in filenames if f.endswith(".py")]
    assert len(paths) > 10
    scanned = {os.path.relpath(p, ROOT) for p in paths}
    for module in ("train/losses", "train/parameters", "train/utils", "train/trainer",
                   "train/train", "data/dataset", "data/dcase", "data/jamendo"):
        assert f"musicfpaugment_torch/{module}.py" in scanned, module
    for path in paths:
        for mod in _imports(path):
            assert mod.split(".")[0] not in banned, (path, mod)


def test_lane_tier_is_bit_identical_to_full_width(slice_state):
    """match_waveforms slices the compacted hashes to the smallest pow2 tier
    covering every used lane; dropped lanes are invalid, so the match equals
    the full-width one."""
    from musicfpaugment_torch.afp.audfprint import landmarks as lm
    from musicfpaugment_torch.afp.audfprint.matcher_device import _match_impl
    from musicfpaugment_torch.afp.audfprint.peaks import find_peaks_batch

    t_ht, _, crops, _ = slice_state
    dm = DeviceMatcher(t_ht, device="cpu")
    masks = find_peaks_batch(torch.from_numpy(crops[:6]))
    C = masks.shape[-1]
    max_peaks = -(-5 * C // 128) * 128
    th, v = lm.hashes_from_masks_batched(masks, max_peaks, max_peaks * lm.MAXPAIRSPERPEAK)
    t, h, v = lm.sort_dedup_hashes(th[..., 0], th[..., 1], v)
    n = t.shape[-1]
    t, h, nv = lm.compact_valid_first(t, h, v, out_len=n)
    tier = 1 << int(np.ceil(np.log2(max(int(nv.max()), 64))))
    assert tier < n, "queries too dense for the tier test"
    kw = dm._match_kwargs(dm._effective_mqf(C - 1))
    full = _match_impl(dm._table, dm._counts, dm._hpit, t, h,
                       torch.arange(n) < nv[:, None], **kw)
    tiered = _match_impl(dm._table, dm._counts, dm._hpit, t[:, :tier], h[:, :tier],
                         torch.arange(tier) < nv[:, None], **kw)
    for f, g in zip(full[:3], tiered[:3]):
        assert torch.equal(f, g)
    assert full[3] == tiered[3]


def test_hash_budget_overflow_warns(slice_state):
    t_ht, _, crops, _ = slice_state
    dm = DeviceMatcher(t_ht, device="cpu")
    with pytest.warns(UserWarning, match="64-hash budget"):
        out = dm.match_waveforms(crops[:2], max_query_hashes=64)
    assert len(out) == 2

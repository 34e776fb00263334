"""The Dejavu reference-scale proof (musicfpaugment_torch.testing.
dejavu_scale) against the JAX package, on the CPU at a small size.

- The ingest program on given 30 s waveforms (numpy, from a seed): packed
  (key, offset) rows, padding included, stored counts and overflow counts
  bit-identical to the JAX proof's program (PSD peaks, packed hashes,
  compaction to 2048 lanes).
- The ingest stage in two invocations at a hash cap of 1 row per key, so
  that ``finalize`` drops rows: the saved index, and its CSR arrays, depth
  and dropped count, bit-identical to an index the test builds from the JAX
  program's rows (the npz loads in both packages).
- The match stage with the UNet arm: every result field that the proof
  scores equal to the JAX ``DejavuDeviceMatcher``'s on the same crops, the
  three accuracies equal to the JAX results scored by the JAX proof's rules;
  the Python ``align_matches`` oracle agrees with the device on every query.
- The report's keys equal those of the JAX proof's committed
  dejavu_results.json; each stage runs as a CLI with ``--device cpu`` and
  raises without it where CUDA is absent.
All comparisons are exact.
"""

import functools
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.afp.dejavu import DejavuDeviceIndex, DejavuDeviceMatcher
from musicfpaugment_torch.convert import unet_denoiser, unet_state_dict_to_flax
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.models import UNet
from musicfpaugment_torch.testing import dejavu_scale as ds
from musicfpaugment_torch.testing import scale_proof as sp
from musicfpaugment_tpu.afp.audfprint.landmarks import compact_valid_first as j_compact_valid_first
from musicfpaugment_tpu.afp.dejavu.matcher_device import DejavuDeviceIndex as JDejavuDeviceIndex
from musicfpaugment_tpu.afp.dejavu.matcher_device import DejavuDeviceMatcher as JDejavuDeviceMatcher
from musicfpaugment_tpu.models import UNet as JUNet

from torch_port_helpers import few_threads, identity_unet_with_bias, tracks_from  # noqa: F401

jfp = importlib.import_module("musicfpaugment_tpu.afp.dejavu.fingerprint")

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = ds.SR
N_TRACKS = 10
BATCH = 4
CAP = 1


def args_of(stage, workdir, *flags):
    return ds.parser().parse_args([stage, "--workdir", str(workdir), "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def waves():
    return next(synthetic_clean_batches(N_TRACKS, ds.TRACK_SECONDS * SR, SR, seed=6))


@pytest.fixture(scope="module")
def jax_batches(waves):
    """The JAX proof's per-batch program on the given waveforms."""
    max_peaks = ds.ingest_max_peaks(ds.TRACK_SECONDS * SR)
    out = []
    for start in range(0, N_TRACKS, BATCH):
        wavs = jnp.asarray(waves[np.arange(start, start + BATCH) % N_TRACKS])
        _, masks, _ = jfp.fingerprint_spectrogram_batch(wavs, SR, 512, 256, 50.0)
        keys, t1, valid, _kf, _nd, n_po = jfp.pack_hashes_from_masks(masks, max_peaks)
        k, t, nv = j_compact_valid_first(keys, t1, valid, out_len=ds.HCAP)
        nv = np.asarray(nv)
        out.append((start, min(BATCH, N_TRACKS - start), np.asarray(jnp.stack([k, t], axis=-1)),
                    np.minimum(nv, ds.HCAP), int(np.sum(nv > ds.HCAP)) + int(n_po)))
    return out


def jax_index(batches, cap):
    """The JAX proof's drain of the rows into a JAX index."""
    idx = JDejavuDeviceIndex(max_rows_per_hash=cap)
    for start, n, kt, counts, _ in batches:
        for j in range(n):
            c = int(counts[j])
            idx.names.append(f"t{start + j:06d}")
            idx.total_hashes.append(c)
            idx._keys.append(kt[j, :c, 0].astype(np.int32))
            idx._offs.append(kt[j, :c, 1].astype(np.int32))
    return idx


def test_ingest_program_bit_identical(waves, jax_batches):
    max_peaks = ds.ingest_max_peaks(ds.TRACK_SECONDS * SR)
    assert max_peaks == 3840
    for start, _, kt, counts, over in jax_batches:
        got = ds.ingest_rows(tracks_from(waves)(np.arange(start, start + BATCH)), max_peaks)
        np.testing.assert_array_equal(got[0].numpy(), kt)  # padding slots included
        np.testing.assert_array_equal(got[1].numpy(), counts)
        assert int(got[2]) == over == 0
    assert all((b[3] > 300).all() for b in jax_batches)


def test_ingest_and_finalize_at_a_dropping_cap_bit_identical(waves, jax_batches, tmp_path):
    for n in (8, N_TRACKS):  # two invocations: the index is saved and reloaded
        ds.stage_ingest(args_of("ingest", tmp_path, "--tracks", str(n), "--batch", str(BATCH),
                                "--hash-cap", str(CAP)), tracks=tracks_from(waves))
    path = str(tmp_path / "dejavu_index.npz")
    want = jax_index(jax_batches, CAP)
    for idx in (DejavuDeviceIndex.load(path), JDejavuDeviceIndex.load(path)):
        assert idx.names == want.names and idx.total_hashes == want.total_hashes
        assert idx.max_rows_per_hash == CAP
        for a, b in zip(idx._keys + idx._offs, want._keys + want._offs):
            np.testing.assert_array_equal(a, b)
        starts, rows, nbuckets, depth = idx.finalize()
        w_starts, w_rows, w_nbuckets, w_depth = want.finalize()
        np.testing.assert_array_equal(starts, w_starts)
        np.testing.assert_array_equal(rows, w_rows)
        assert (nbuckets, depth, idx.rows_dropped) == (w_nbuckets, w_depth, want.rows_dropped)
    assert want.rows_dropped > 0 and w_depth == CAP
    state = sp.load_state(str(tmp_path))
    assert state["total_rows"] == sum(want.total_hashes)
    assert state["ingest_done"] and state["hash_cap"] == CAP and state["hash_overflow"] == 0


@pytest.fixture(scope="module")
def matched(tmp_path_factory):
    work = tmp_path_factory.mktemp("dejavu_match")
    waves = next(synthetic_clean_batches(12, ds.TRACK_SECONDS * SR, SR, seed=9))
    model = identity_unet_with_bias()
    torch.save({"model": model.state_dict()}, str(work / "unet.pt"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp, "UNet", functools.partial(UNet, base=8))
        ds.stage_ingest(args_of("ingest", work, "--tracks", "12", "--batch", "4"), tracks=tracks_from(waves))
        args = args_of("match", work, "--queries", "8", "--batch", "4", "--denoise",
                       "--unet-pkl", str(work / "unet.pt"),
                       "--conditions", "cleans,bn_m10,default_parameters")
        ds.stage_match(args, tracks=tracks_from(waves))
        ds.stage_oracle(args_of("oracle", work, "--oracle-n", "6"), tracks=tracks_from(waves))
    return work, waves, model, args


FIELDS = ("song_name", "nb_matches_with_offset", "hashes_matched_in_input", "offset")


def test_match_results_and_accuracies_equal_jax(matched):
    work, waves, model, args = matched
    state = sp.load_state(str(work))
    params, stats = unet_state_dict_to_flax(model.state_dict())
    jm = JUNet(1, 1, rate=0.05, base=8)
    j_hook = lambda s: jm.apply({"params": params, "batch_stats": stats}, s, train=False)
    jidx = JDejavuDeviceIndex.load(str(work / "dejavu_index.npz"))
    jdm, jdm_den = JDejavuDeviceMatcher(jidx), JDejavuDeviceMatcher(jidx, spec_denoiser=j_hook)
    qidx, offsets = sp.query_plan(12, 8, 42)
    ties = moved = 0
    for cond, params_c in sp.select_conditions(args.conditions).items():
        fp = sp.condition_augmenter(params_c, args) if params_c is not None else None
        correct = [0, 0, 0]
        for _, tids, crops in sp.condition_batches(tracks_from(waves), fp, qidx, offsets, 4):
            res = jdm.match_waveforms(crops.numpy())
            res_den = jdm_den.match_waveforms(crops.numpy())
            for r, rd, tid in zip(res, res_den, tids):
                nm = r["nb_matches_with_offset"] if r else -1
                nmd = rd["nb_matches_with_offset"] if rd else -1
                correct[0] += ds.is_hit(r, tid)
                correct[1] += ds.is_hit(rd, tid)
                correct[2] += ds.is_hit(r if nm >= nmd else rd, tid)
                ties += nm == nmd
                moved += nm != nmd
        got = state["conditions"][cond]
        assert [got["accuracy"], got["accuracy_den"], got["accuracy_mix"]] == [
            round(c / 8, 4) for c in correct], cond
    assert ties > 0 and moved > 0
    assert state["rows_dropped"] == 0 and state["total_rows_stored"] == state["total_rows"]


@pytest.mark.parametrize("denoised", [False, True])
def test_device_results_equal_jax_field_by_field(matched, denoised):
    work, waves, model, args = matched
    params, stats = unet_state_dict_to_flax(model.state_dict())
    jm = JUNet(1, 1, rate=0.05, base=8)
    j_hook = lambda s: jm.apply({"params": params, "batch_stats": stats}, s, train=False)
    idx = DejavuDeviceIndex.load(str(work / "dejavu_index.npz"))
    jidx = JDejavuDeviceIndex.load(str(work / "dejavu_index.npz"))
    qidx, offsets = sp.query_plan(12, 8, 42)
    fp = sp.condition_augmenter(sp.select_conditions("bn_p10")["bn_p10"], args)
    crops = next(sp.condition_batches(tracks_from(waves), fp, qidx, offsets, 8))[2]
    got = DejavuDeviceMatcher(
        idx, spec_denoiser=unet_denoiser(model) if denoised else None, device="cpu"
    ).match_waveforms(crops)
    want = JDejavuDeviceMatcher(jidx, spec_denoiser=j_hook if denoised else None).match_waveforms(
        crops.numpy())
    assert [{k: g.get(k) for k in FIELDS} for g in got] == [{k: w.get(k) for k in FIELDS} for w in want]
    assert sum(bool(g) for g in got) >= 4


def test_python_oracle_agrees_with_the_device(matched):
    work = matched[0]
    assert sp.load_state(str(work))["oracle_agreement"] == "6/6"
    starts = np.array([0, 0, 2, 3], np.int32)
    rows = np.array([(0 << 14) | 10, (1 << 14) | 12, (1 << 14) | 30], np.uint32)
    # one hit in each (song, dt) cell: a song's best dt is its smallest, and
    # the tie between the two songs goes to the smaller id
    assert ds.python_align_oracle(starts, rows, 14, ["a", "b"], [(1, 5), (1, 7), (9, 0)]) == {
        "song_name": "a", "nb_matches_with_offset": 1, "hashes_matched": 1, "offset": 3}
    assert ds.python_align_oracle(starts, rows, 14, ["a", "b"], [(0, 1)]) is None


def test_cli_stages_and_report_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(sp, "UNet", functools.partial(UNet, base=8))
    unet = tmp_path / "unet.pt"
    torch.save({"model": identity_unet_with_bias().state_dict()}, str(unet))
    common = ["--workdir", str(tmp_path), "--device", "cpu", "--batch", "4"]
    for argv in (
        ["ingest", "--tracks", "6"],
        ["match", "--queries", "4", "--denoise", "--unet-pkl", str(unet),
         "--conditions", "cleans,bn_m10"],
        ["oracle", "--oracle-n", "2"],
        ["report"],
    ):
        ds.main(argv + common)
    got = json.load(open(tmp_path / "dejavu_results.json"))
    want = json.load(open(os.path.join(ROOT, "examples", "scale_out", "dejavu_results.json")))
    assert set(got) == set(want)
    for cond in ("cleans", "bn_m10"):
        assert set(got["conditions"][cond]) == set(want["conditions"][cond]), cond
    assert got["oracle_agreement"] == "2/2" and got["hash_cap"] == 1024


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
@pytest.mark.parametrize("stage", ["ingest", "match", "oracle", "report"])
def test_cli_raises_without_cuda(stage, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.main([stage, "--workdir", str(tmp_path)])

"""The audfprint reference-scale proof (musicfpaugment_torch.testing.
scale_proof) and the end-to-end demo against the JAX package, on the CPU at
a small size.

- The ingest stage from given 30 s waveforms (numpy, from a seed) into a
  table of 2^12 buckets x depth 3, so that it saturates: the table, its
  counts and names and the statistics bit-identical to a table built with
  the JAX package's functions in the proof's order (peaks, batched hashes,
  sort and dedup, compaction to 4096 lanes, ``HashTable.store`` per track),
  in one invocation and in two (each with a freshly loaded table whose
  reservoir stream restarts, as the JAX proof's does).
- The match stage with the UNet arm (``--denoise``; a ``base=8`` UNet,
  identity plus an output bias, carried to Flax by ``convert.py``): every
  verdict of both arms equal to the JAX ``DeviceMatcher.match_waveforms``'
  on the same crops, and the three accuracies equal to the JAX verdicts
  scored by the JAX proof's mix rule; the rule's tie goes to the
  undenoised verdict.
- The report's keys equal those of the JAX proof's committed results.json.
- Each stage and the demo run as CLIs with ``--device cpu``; without it
  they raise where CUDA is absent.
All comparisons are exact.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.afp.audfprint import DeviceMatcher, HashTable
from musicfpaugment_torch.convert import unet_denoiser, unet_state_dict_to_flax
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.models import Demucs, UNet
from musicfpaugment_torch.testing import full_pipeline_demo
from musicfpaugment_torch.testing import scale_proof as sp
from musicfpaugment_tpu.afp.audfprint import DeviceMatcher as JDeviceMatcher
from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
from musicfpaugment_tpu.afp.audfprint import landmarks as jlm
from musicfpaugment_tpu.afp.audfprint.peaks import find_peaks_batch as j_find_peaks_batch
from musicfpaugment_tpu.models import UNet as JUNet

from torch_port_helpers import few_threads, identity_unet_with_bias, tracks_from  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = sp.SR
N_TRACKS = 10
BATCH = 4
SMALL_TABLE = dict(hashbits=12, depth=3)


@pytest.fixture(scope="module")
def waves():
    return next(synthetic_clean_batches(N_TRACKS, sp.TRACK_SECONDS * SR, SR, seed=5))


def args_of(stage, workdir, *flags, module=sp):
    return module.parser().parse_args([stage, "--workdir", str(workdir), "--device", "cpu", *flags])


def jax_ingest_batches(waves, n_tracks, batch):
    """The JAX proof's per-batch program on given waveforms: (start, tracks
    to store, (B, HCAP, 2) rows, counts, overflow) per batch."""
    out = []
    for start in range(0, n_tracks, batch):
        masks = j_find_peaks_batch(jnp.asarray(waves[np.arange(start, start + batch) % len(waves)]))
        max_peaks = -(-5 * int(masks.shape[-1]) // 128) * 128
        th, v = jlm.hashes_from_masks_batched(
            masks, max_peaks=max_peaks, max_hashes=max_peaks * jlm.MAXPAIRSPERPEAK
        )
        t, h, v = jlm.sort_dedup_hashes(th[..., 0], th[..., 1], v)
        t, h, n = jlm.compact_valid_first(t, h, v, out_len=sp.HCAP)
        out.append((start, min(batch, n_tracks - start), np.asarray(jnp.stack([t, h], axis=-1)),
                    np.minimum(np.asarray(n), sp.HCAP), int(np.sum(np.asarray(n) > sp.HCAP))))
    return out


def jax_store(ht, batches):
    for start, n, th, counts, _ in batches:
        for j in range(n):
            ht.store(f"t{start + j:06d}", th[j, : counts[j]])
    return ht


def assert_same_table(port_path, jht):
    for ht in (HashTable(port_path), JHashTable(port_path)):  # the npz loads in both
        np.testing.assert_array_equal(ht.table, jht.table)
        np.testing.assert_array_equal(ht.counts, jht.counts)
        np.testing.assert_array_equal(np.asarray(ht.hashesperid, np.int64),
                                      np.asarray(jht.hashesperid, np.int64))
        assert list(ht.names) == list(jht.names)


def expected_statistics(jht):
    stored = int(np.sum(np.minimum(jht.depth, jht.counts)))
    total = jht.totalhashes()
    return dict(
        total_hashes=total, stored_hashes=stored,
        reservoir_dropped_pct=round(100.0 * (total - stored) / total, 3),
        buckets_at_depth=int(np.sum(jht.counts >= jht.depth)),
        buckets_over_depth=int(np.sum(jht.counts > jht.depth)),
        max_bucket_count=int(jht.counts.max()),
    )


@pytest.fixture(scope="module")
def jax_batches(waves):
    return jax_ingest_batches(waves, N_TRACKS, BATCH)


def test_ingest_program_bit_identical(waves, jax_batches):
    for start, _, th, counts, over in jax_batches:
        got = sp.ingest_hashes(tracks_from(waves)(np.arange(start, start + BATCH)))
        np.testing.assert_array_equal(got[0].numpy(), th)  # padding slots included
        np.testing.assert_array_equal(got[1].numpy(), counts)
        assert int(got[2]) == over == 0
    assert all((b[3] > 500).all() for b in jax_batches)


def test_ingest_at_saturation_bit_identical(waves, jax_batches, tmp_path, monkeypatch):
    monkeypatch.setattr(sp, "HashTable", functools.partial(HashTable, **SMALL_TABLE))
    sp.stage_ingest(args_of("ingest", tmp_path, "--tracks", str(N_TRACKS), "--batch", str(BATCH)),
                    tracks=tracks_from(waves))
    jht = jax_store(JHashTable(**SMALL_TABLE), jax_batches)
    assert_same_table(str(tmp_path / "table.npz"), jht)
    state = sp.load_state(str(tmp_path))
    want = expected_statistics(jht)
    assert {k: state[k] for k in want} == want
    assert want["buckets_over_depth"] > 0 and want["reservoir_dropped_pct"] > 0
    assert state["next_track"] == state["tracks_target"] == N_TRACKS
    assert state["ingest_done"] and state["hash_overflow"] == 0
    assert len(state["ingest_batch_seconds"]) == 3  # 4 + 4 + the last 2 of a batch of 4


def test_ingest_in_two_chunks_bit_identical(waves, jax_batches, tmp_path, monkeypatch):
    """Two invocations: the second reloads the table, whose reservoir stream
    restarts at default_rng(0), as the JAX proof's HashTable(path) does."""
    monkeypatch.setattr(sp, "HashTable", functools.partial(HashTable, **SMALL_TABLE))
    for n in (8, N_TRACKS):
        sp.stage_ingest(args_of("ingest", tmp_path, "--tracks", str(n), "--batch", str(BATCH)),
                        tracks=tracks_from(waves))
    first = tmp_path / "jax_first.npz"
    jax_store(JHashTable(**SMALL_TABLE), jax_batches[:2]).save(str(first), compress=False)
    jht = jax_store(JHashTable(str(first)), jax_batches[2:])
    assert_same_table(str(tmp_path / "table.npz"), jht)
    state = sp.load_state(str(tmp_path))
    want = expected_statistics(jht)
    assert {k: state[k] for k in want} == want
    # the restarted stream draws other slots than an uninterrupted run
    whole = jax_store(JHashTable(**SMALL_TABLE), jax_batches)
    assert not np.array_equal(whole.table, jht.table)
    np.testing.assert_array_equal(whole.counts, jht.counts)


def test_mix_rule_ties_go_to_the_undenoised_verdict():
    v = [("MATCH", "t000001", 7), ("MATCH", "t000001", 7), ("NOMATCH", "", 0), ("MATCH", "t000002", 6)]
    vd = [("MATCH", "t000002", 7), ("MATCH", "t000002", 8), ("MATCH", "t000002", 9), ("MATCH", "t000001", 5)]
    assert sp.score_batch(v, vd, [2, 2, 2, 2], True) == (1, 3, 3)
    assert sp.score_batch(v, vd, [1, 1, 1, 1], True) == (2, 1, 1)
    assert sp.score_batch(v, vd, [1, 1, 1, 1], False) == (2, 0, 0)


@pytest.fixture(scope="module")
def matched(tmp_path_factory):
    """The ingest of 12 given tracks (depth 20), a UNet checkpoint, and the
    match stage with the UNet arm over 8 queries of 3 conditions."""
    work = tmp_path_factory.mktemp("scale_match")
    waves = next(synthetic_clean_batches(12, sp.TRACK_SECONDS * SR, SR, seed=8))
    model = identity_unet_with_bias()
    torch.save({"model": model.state_dict()}, str(work / "unet.pt"))
    flags = ("--queries", "8", "--batch", "4", "--shifts", "4",
             "--conditions", "cleans,bn_m10,default_parameters")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp, "HashTable", functools.partial(HashTable, depth=20))
        mp.setattr(sp, "UNet", functools.partial(UNet, base=8))
        sp.stage_ingest(args_of("ingest", work, "--tracks", "12", "--batch", "4"), tracks=tracks_from(waves))
        args = args_of("match", work, *flags, "--denoise")
        sp.stage_match(args, tracks=tracks_from(waves))
    return work, waves, model, args


def test_match_verdicts_and_accuracies_equal_jax(matched):
    work, waves, model, args = matched
    state = sp.load_state(str(work))
    params, stats = unet_state_dict_to_flax(model.state_dict())
    jm = JUNet(1, 1, rate=0.05, base=8)
    j_hook = lambda s: jm.apply({"params": params, "batch_stats": stats}, s, train=False).astype(jnp.float32)
    t_hook = unet_denoiser(model)
    jdm = JDeviceMatcher(JHashTable(str(work / "table.npz")))
    tdm = DeviceMatcher(HashTable(str(work / "table.npz")), device="cpu")
    qidx, offsets = sp.query_plan(12, 8, 42)
    ties = moved = 0
    for cond, params_c in sp.select_conditions(args.conditions).items():
        fp = sp.condition_augmenter(params_c, args) if params_c is not None else None
        correct = [0, 0, 0]
        for _, tids, crops in sp.condition_batches(tracks_from(waves), fp, qidx, offsets, 4):
            v = [tuple(x) for x in jdm.match_waveforms(crops.numpy(), shifts=4)]
            vd = [tuple(x) for x in jdm.match_waveforms(crops.numpy(), shifts=4, denoiser=j_hook)]
            assert tdm.match_waveforms(crops, shifts=4) == v
            assert tdm.match_waveforms(crops, shifts=4, denoiser=t_hook) == vd
            for a, b, tid in zip(v, vd, tids):
                gt = f"t{tid:06d}"
                best = a if a[2] >= b[2] else b  # the JAX proof's mix rule
                correct[0] += a[0] == "MATCH" and a[1] == gt
                correct[1] += b[0] == "MATCH" and b[1] == gt
                correct[2] += best[0] == "MATCH" and best[1] == gt
                ties += a[2] == b[2]
                moved += a[2] != b[2]
        got = state["conditions"][cond]
        assert [got["accuracy"], got["accuracy_den"], got["accuracy_mix"]] == [
            round(c / 8, 4) for c in correct], cond
        assert got["n_queries"] == 8
    assert ties > 0 and moved > 0  # both branches of the mix rule ran
    assert state["eff_depth"] <= 20 and state["match_shifts"] == 4 and state["match_denoise"]


def test_match_resumes_and_skips_done_conditions(matched, capsys):
    work, waves, _, args = matched
    before = sp.load_state(str(work))["conditions"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sp, "UNet", functools.partial(UNet, base=8))
        sp.stage_match(args, tracks=tracks_from(waves))
    assert sp.load_state(str(work))["conditions"] == before
    assert "bn_m10 {" not in capsys.readouterr().out


def test_cli_stages_and_report_keys(tmp_path, monkeypatch):
    """Every stage through ``main`` at a tiny size on the CPU, on the
    synthetic corpus: the report has the JAX proof's keys, at the top and
    in each condition that went through the same stages."""
    monkeypatch.setattr(sp, "UNet", functools.partial(UNet, base=8))
    monkeypatch.setattr(sp, "Demucs", functools.partial(Demucs, hidden=4, depth=2))
    common = ["--workdir", str(tmp_path), "--device", "cpu", "--batch", "4"]
    q = ["--queries", "4", "--shifts", "4"]
    for argv in (
        ["ingest", "--tracks", "6"],
        ["train", "--train-epochs", "1", "--train-steps", "1", "--train-batch", "2"],
        ["train", "--model", "demucs", "--train-epochs", "1", "--train-steps", "1",
         "--train-batch", "2"],
        ["match", *q, "--denoise", "--conditions", "cleans,bn_m10"],
        ["match", *q, "--denoise", "--denoise-model", "demucs", "--conditions", "bn_m10"],
        ["peaks", "--queries", "4", "--denoise", "--conditions", "bn_m10"],
        ["oracle", "--oracle-n", "2", "--shifts", "4"],
        ["report"],
    ):
        sp.main(argv + common)
    got = json.load(open(tmp_path / "results.json"))
    want = json.load(open(os.path.join(ROOT, "examples", "scale_out", "results.json")))
    assert set(got) == set(want)
    for cond in ("cleans", "bn_m10"):
        assert set(got["conditions"][cond]) == set(want["conditions"][cond]), cond
    assert set(got["denoiser_train"]) == set(want["denoiser_train"])
    assert got["oracle_agreement"] == "2/2" and got["tracks_target"] == 6
    assert len(got["denoiser_train"]["val_loss"]) == 1
    assert os.path.exists(tmp_path / "unet.pt") and os.path.exists(tmp_path / "demucs.pt")
    for v in got["conditions"]["bn_m10"].values():
        assert np.isfinite(v)


def test_demo_cli_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(full_pipeline_demo, "UNet", functools.partial(UNet, base=8))
    got = full_pipeline_demo.main([
        "--tracks", "4", "--epochs", "1", "--steps", "1", "--batch", "2", "--queries", "4",
        "--conditions", "bn_0", "--device", "cpu", "--out", str(tmp_path),
    ])
    assert json.load(open(tmp_path / "results.json")) == json.loads(json.dumps(got))
    assert set(got) == {"model", "train_val_loss", "train_seconds", "cleans", "bn_0", "total_seconds"}
    assert set(got["cleans"]["accuracy"]) == {"No Denoising", "With Denoising", "Mix Pipeline"}
    assert got["cleans"]["accuracy"]["No Denoising"] == 1.0
    assert set(got["bn_0"]["peaks"]) == {
        "precision_no_den", "recall_no_den", "f1_score_no_den", "psnr_no_den_spec",
        "prec_den", "rec_den", "f1_den", "psnr_den_spec"}
    assert sorted(os.listdir(tmp_path / "queries")) == ["bn_0", "cleans"]
    assert len(os.listdir(tmp_path / "queries" / "bn_0")) == 4


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
@pytest.mark.parametrize("stage", ["ingest", "train", "match", "peaks", "oracle", "report"])
def test_cli_raises_without_cuda(stage, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sp.main([stage, "--workdir", str(tmp_path)])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_demo_raises_without_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        full_pipeline_demo.main(["--out", str(tmp_path)])

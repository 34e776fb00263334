"""Port parity: the port's random draws are the JAX package's.

Every random quantity of the JAX package comes from threefry keys; the
port draws them with ``core/prng.py`` along the same key trees:

- the storage-free corpus: ``synth_tracks_device(seed, i)`` against JAX's
  ``synth_tracks_device(PRNGKey(seed), i)`` at 1 s and 30 s, within 1e-5 of
  the peak (float sums in another order), and the audfprint hashes of those
  tracks at least 0.999 equal;
- each transform's ``draw(key)`` against the draws the JAX transform makes
  under that key (integers and gates exactly, floats within 1e-5 relative:
  the cutoffs' ``10 ** x - 1`` is float32 in JAX, float64 in the port);
- ``AugmentFP.batch_augment(key=)`` and ``batch_augment_indexed(base_key=)``
  against JAX's on the same key, for the four parameter sets and four modes
  of tests/test_torch_augment.py, within its CHAIN_ATOL;
- the frozen-seed-42 queries: ``generate_augmented_queries``' pickles and the
  scale proof's crops (track ids, offsets, augmentation) against JAX's,
  within 1e-5;
- the trainer's first augmented training and validation batches against the
  JAX trainer's, within CHAIN_ATOL;
- the Dejavu cap sweep on a 64-track ingest: under each cap its CSR arrays
  and dropped rows bit-identical to the JAX package's ``finalize`` with that
  ``max_rows_per_hash``, and its verdicts equal to the JAX matcher's;
- the big-bank training step, one step on the CPU.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch import augment as taugment
from musicfpaugment_torch.afp.dejavu import DejavuDeviceMatcher
from musicfpaugment_torch.augment import transforms as TT
from musicfpaugment_torch.core import noise as tnoise
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.data.synthetic import synth_tracks_device, synthetic_clean_batches
from musicfpaugment_torch.models import UNet
from musicfpaugment_torch.testing import dejavu_cap_sweep as cs
from musicfpaugment_torch.testing import dejavu_scale as ds
from musicfpaugment_torch.testing import generate_queries as tgen
from musicfpaugment_torch.testing import scale_proof as sp
from musicfpaugment_torch.train import big_bank_train
from musicfpaugment_torch.train.trainer import Trainer
from musicfpaugment_tpu import augment as jaugment
from musicfpaugment_tpu.afp.dejavu.matcher_device import DejavuDeviceIndex as JDejavuDeviceIndex
from musicfpaugment_tpu.afp.dejavu.matcher_device import DejavuDeviceMatcher as JDejavuDeviceMatcher
from musicfpaugment_tpu.core import noise as jnoise
from musicfpaugment_tpu.data.synthetic import synth_tracks_device as j_synth_tracks_device
from musicfpaugment_tpu.models import UNet as JUNet
from musicfpaugment_tpu.parallel import make_mesh
from musicfpaugment_tpu.testing import generate_queries as jgen
from musicfpaugment_tpu.testing import parameters as jparams
from musicfpaugment_tpu.train import trainer as jtrainer

from test_torch_augment import CHAIN_ATOL, MODES, PARAMETER_SETS
from test_torch_transforms import CASES
from torch_port_helpers import SR, few_threads, jax_stage_draws, music, port_banks  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

T = 12000
TRACK_ATOL = 1e-5  # of the peak
QUERY_ATOL = 1e-5


def _key(seed):
    return jax.random.PRNGKey(seed), prng.key(seed)


@pytest.fixture(scope="module")
def jbanks():
    return jaugment.synthetic_banks(
        sample_rate=SR, num_noise=8, num_irs=4, noise_row_length=9 * SR, seed=1)


@pytest.fixture(scope="module")
def tbanks(jbanks):
    return port_banks(*jbanks)


# ------------------------------------------------------------ corpus


@pytest.mark.parametrize("seconds", [1, 30])
def test_corpus_tracks_are_jax_tracks(seconds):
    idx = np.array([0, 5, 1000, 106573])
    got = synth_tracks_device(1234, idx, seconds * SR, SR, device="cpu").numpy()
    want = np.asarray(j_synth_tracks_device(jax.random.PRNGKey(1234), jnp.asarray(idx), seconds * SR))
    assert got.shape == want.shape == (4, seconds * SR) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= TRACK_ATOL * float(np.abs(want).max())
    if seconds == 30:
        got_h, got_n, _ = sp.ingest_hashes(torch.from_numpy(got))
        want_h, want_n, _ = sp.ingest_hashes(torch.from_numpy(want.copy()))
        same = total = 0
        for i in range(len(idx)):
            a = set(map(tuple, got_h[i, : got_n[i]].tolist()))
            b = set(map(tuple, want_h[i, : want_n[i]].tolist()))
            same += len(a & b)
            total += max(len(a), len(b))
        assert total > 3000 and same / total >= 0.999, (same, total)


def test_corpus_tracks_do_not_depend_on_their_batch_or_seed_words():
    whole = synth_tracks_device(7, range(6), SR, SR, device="cpu")
    parts = torch.cat([synth_tracks_device(7, [i], SR, SR, device="cpu") for i in range(6)])
    assert float((whole - parts).abs().max()) <= 1e-6
    other = synth_tracks_device(8, range(6), SR, SR, device="cpu")
    assert float((whole - other).abs().max()) > 0.1


# ------------------------------------------------------------ draws


def _assert_draws_equal(got, want):
    assert set(got) == set(want), (set(got), set(want))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if w.dtype.is_floating_point:
            d = (g - w).abs()
            assert bool((d <= 1e-5 * w.abs() + 1e-7).all()), (k, float(d.max()))
        else:
            assert torch.equal(g, w), k


@pytest.mark.parametrize("case", list(CASES))
def test_transform_draws_are_jax_draws(case, jbanks, tbanks):
    cls, kwargs = CASES[case]
    jt = getattr(jaugment.transforms, cls)(p=0.5, **kwargs)
    tt = getattr(TT, cls)(p=0.5, **kwargs)
    jkey, tkey = _key(17)
    want = jax_stage_draws(jt, jkey, 8, T, jbanks[0], jbanks[1])
    got = tt.draw(tkey, 8, T, SR, noise_bank=tbanks[0], ir_bank=tbanks[1])
    _assert_draws_equal(got, want)


def test_colored_noise_is_jax_colored_noise():
    jkey, tkey = _key(3)
    f = np.asarray([-2.0, 0.0, 1.0, 2.0], np.float32)
    want = np.asarray(jnoise.batch_colored_noise(jkey, jnp.asarray(f), 20000, SR))
    got = tnoise.batch_colored_noise(tkey, torch.from_numpy(f), 20000, SR).numpy()
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())
    want_one = np.asarray(jnoise.gen_colored_noise(jkey, 1.0, 500, SR))
    got_one = tnoise.gen_colored_noise(tkey, 1.0, 500, SR, device="cpu").numpy()
    assert float(np.abs(got_one - want_one).max()) <= 1e-5 * float(np.abs(want_one).max())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("params", list(PARAMETER_SETS))
def test_batch_augment_and_indexed_are_jax(params, mode, jbanks, tbanks):
    parameters = PARAMETER_SETS[params]
    jfp = jaugment.AugmentFP(
        jbanks[0], SR, parameters=parameters, impulse_response_dir=jbanks[1], **MODES[mode])
    tfp = taugment.AugmentFP(
        tbanks[0], SR, parameters=parameters, impulse_response_dir=tbanks[1], device="cpu",
        **MODES[mode])
    x = music(batch=8, samples=T, seed=21, channels=1)
    x[5] = 0.0
    jkey, tkey = _key(13)
    want = np.asarray(jfp.batch_augment(jnp.asarray(x), key=jkey))
    got = tfp.batch_augment(x, key=tkey).numpy()
    assert float(np.abs(got - want).max()) <= CHAIN_ATOL
    jfp.freeze_parameters(42)
    tfp.freeze_parameters(42)
    idx = np.arange(100, 108)
    want = np.asarray(jfp.batch_augment_indexed(jnp.asarray(x), idx))
    got = tfp.batch_augment_indexed(x, idx).numpy()
    assert float(np.abs(got - want).max()) <= CHAIN_ATOL
    # the stream that an unfrozen augmenter advances is JAX's too
    jfp.freeze_parameters(5)
    tfp.freeze_parameters(5)
    jfp.are_parameters_frozen = tfp.are_parameters_frozen = False
    jfp.batch_augment(jnp.asarray(x))
    tfp.batch_augment(x)
    want = np.asarray(jfp.batch_augment(jnp.asarray(x)))
    assert float(np.abs(tfp.batch_augment(x).numpy() - want).max()) <= CHAIN_ATOL


def test_indexed_draws_are_each_examples_own(tbanks):
    """``draw_indexed`` is ``draw`` under each example's folded key, as a
    batch of one."""
    fp = taugment.AugmentFP(tbanks[0], SR, impulse_response_dir=tbanks[1], device="cpu")
    base = prng.key(42)
    whole = fp.draw_indexed([3, 9, 4], T, base)
    for j, i in enumerate([3, 9, 4]):
        one = fp.draw(1, T, prng.fold_in(base, i))
        for d_all, d_one in zip(whole, one):
            for k in d_one:
                assert torch.equal(d_all[k][j : j + 1], d_one[k]), k


# ------------------------------------------------------------ queries


@pytest.mark.parametrize("cond", ["default_parameters", "recording_device"])
def test_frozen_seed_queries_are_jax_queries(cond, jbanks, tbanks, tmp_path):
    cleans = tmp_path / "cleans"
    cleans.mkdir()
    for i, w in enumerate(next(synthetic_clean_batches(6, 8 * SR, seed=41, sample_rate=SR))):
        with open(cleans / f"q{i:02d}.pkl", "wb") as f:
            pickle.dump(w, f)
    params = jparams.test_pipelines_parameters[cond]
    jfp = jaugment.AugmentFP(jbanks[0], SR, parameters=params, impulse_response_dir=jbanks[1])
    tfp = taugment.AugmentFP(tbanks[0], SR, parameters=params, impulse_response_dir=tbanks[1],
                             device="cpu")
    jgen.generate_augmented_queries(str(tmp_path / "j"), params, save=True, augmenter=jfp,
                                    cleans_path=str(cleans), batch_size=4)
    tgen.generate_augmented_queries(str(tmp_path / "t"), params, save=True, augmenter=tfp,
                                    cleans_path=str(cleans), batch_size=4)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 6
    for name in names:
        with open(tmp_path / "j" / name, "rb") as f:
            want = pickle.load(f)
        with open(tmp_path / "t" / name, "rb") as f:
            got = pickle.load(f)
        assert got.shape == want.shape == (8 * SR,)
        assert float(np.abs(got - want).max()) <= QUERY_ATOL


def test_scale_proof_queries_are_jax_queries(jbanks, tbanks):
    """The scale proof's plan over 106,574 tracks, its crops of the corpus
    and their ``default_parameters`` augmentation, against the same steps
    of the JAX proof (crops of JAX's tracks, JAX's frozen augmenter)."""
    qidx, offsets = sp.query_plan(106574, 8, 42)
    rng = np.random.default_rng(42)  # the JAX proof's plan
    np.testing.assert_array_equal(qidx, rng.integers(0, 106574, 8).astype(np.int32))
    np.testing.assert_array_equal(offsets, rng.integers(0, 22 * SR, 8).astype(np.int32))
    params = jparams.test_pipelines_parameters["default_parameters"]
    jfp = jaugment.AugmentFP(jbanks[0], SR, parameters=params, impulse_response_dir=jbanks[1])
    jfp.freeze_parameters(42)
    jtracks = np.asarray(j_synth_tracks_device(jax.random.PRNGKey(1234), jnp.asarray(qidx), 30 * SR))
    jcrops = np.stack([t[o : o + 8 * SR] for t, o in zip(jtracks, offsets)])
    want = np.asarray(jfp.batch_augment_indexed(jnp.asarray(jcrops[:, None, :]), np.arange(8)))[:, 0]
    tfp = taugment.AugmentFP(tbanks[0], SR, parameters=params, impulse_response_dir=tbanks[1],
                             device="cpu")
    tfp.freeze_parameters(42)
    tracks = sp.corpus_tracks(1234, torch.device("cpu"))
    (_, tids, got), = list(sp.condition_batches(tracks, tfp, qidx, offsets, 8))
    np.testing.assert_array_equal(tids, qidx)
    assert float(np.abs(got.numpy() - want).max()) <= QUERY_ATOL


# ------------------------------------------------------------ trainer


def test_trainer_batches_are_jax_trainer_batches(jbanks, tbanks, tmp_path):
    """The first two training batches (step keys split from PRNGKey(seed))
    and the first validation batch (fold_in(PRNGKey(seed + 1), 0)) of both
    trainers, augmented from the same clean batches."""
    train = [next(synthetic_clean_batches(4, SR, SR, seed=s)) for s in (7, 8)]
    val = next(synthetic_clean_batches(4, SR, SR, seed=9))
    jfp = jaugment.AugmentFP(jbanks[0], SR, impulse_response_dir=jbanks[1])
    tfp = taugment.AugmentFP(tbanks[0], SR, impulse_response_dir=tbanks[1], device="cpu")
    jt = jtrainer.Trainer(
        JUNet(1, 1, rate=0.0, base=4), iter(train), 2, iter([val]), 1, 1e-3, 2,
        str(tmp_path / "jax"), input_type="spec", mesh=make_mesh(1), augmenter=jfp,
        example_batch=train[0], seed=31)
    pt = Trainer(
        UNet(1, 1, rate=0.0, base=4), iter(train), 2, iter([val]), 1, 1e-3, 2,
        str(tmp_path / "port"), input_type="spec", augmenter=tfp, device="cpu", seed=31)
    for clean in train:
        k_aug, _ = jax.random.split(jt._next_keys())
        want = np.asarray(jt._make_batch(jnp.asarray(clean), None, k_aug, jt._banks))
        got = pt._make_batch(torch.from_numpy(clean), None)[1].numpy()
        assert got.shape == want.shape == (4, SR)
        assert float(np.abs(got - want).max()) <= CHAIN_ATOL
    k_aug, _ = jax.random.split(jt._val_keys[0])
    want = np.asarray(jt._make_batch(jnp.asarray(val), None, k_aug, jt._banks))
    clean_v, got = next(iter(pt._val_batches()))
    np.testing.assert_array_equal(clean_v.numpy(), val)
    assert float(np.abs(got.numpy() - want).max()) <= CHAIN_ATOL


# ------------------------------------------------------------ cap sweep


CAPS = "1,2,inf"


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    work = tmp_path_factory.mktemp("cap_sweep")
    common = ["--workdir", str(work), "--device", "cpu", "--batch", "16"]
    cs.main(["ingest", "--tracks", "64", *common])
    args = cs.parser().parse_args(
        ["sweep", "--caps", CAPS, "--queries", "16", "--conditions", "cleans,bn_p10", *common])
    report = cs.stage_sweep(args)
    return work, args, report


def test_cap_sweep_csr_is_jax_finalize_under_each_cap(swept):
    work, _, report = swept
    idx = ds.load_index(str(work))
    assert idx.max_rows_per_hash == cs.NO_CAP and len(idx.names) == 64
    total = sum(idx.total_hashes)
    assert report["tracks"] == 64 and report["total_rows_ingested"] == total
    for cap_str in CAPS.split(","):
        starts, rows, nbuckets, depth = cs.refinalize(idx, cs.parse_cap(cap_str))
        jidx = JDejavuDeviceIndex.load(str(work / "dejavu_index.npz"))
        jidx.max_rows_per_hash = cs.parse_cap(cap_str)
        w_starts, w_rows, w_nbuckets, w_depth = jidx.finalize()
        np.testing.assert_array_equal(starts, w_starts)
        np.testing.assert_array_equal(rows, w_rows)
        assert (nbuckets, depth, idx.rows_dropped) == (w_nbuckets, w_depth, jidx.rows_dropped)
        entry = report["caps"][cap_str]
        assert (entry["bucket_depth"], entry["rows_stored"], entry["rows_dropped"]) == (
            depth, rows.size, jidx.rows_dropped)
        assert entry["rows_stored"] + entry["rows_dropped"] == total
    caps = report["caps"]
    assert caps["1"]["rows_dropped"] > caps["2"]["rows_dropped"] > caps["inf"]["rows_dropped"] == 0
    assert caps["1"]["bucket_depth"] == 1 and caps["inf"]["bucket_depth"] > 2
    with open(work / "dejavu_cap_sweep.json") as f:
        assert set(json.load(f)) == {"tracks", "queries", "total_rows_ingested", "caps"}


@pytest.mark.parametrize("cap_str", CAPS.split(","))
def test_cap_sweep_verdicts_equal_jax(swept, cap_str):
    work, args, report = swept
    idx = ds.load_index(str(work))
    cs.refinalize(idx, cs.parse_cap(cap_str))
    jidx = JDejavuDeviceIndex.load(str(work / "dejavu_index.npz"))
    jidx.max_rows_per_hash = cs.parse_cap(cap_str)
    tdm, jdm = DejavuDeviceMatcher(idx, device="cpu"), JDejavuDeviceMatcher(jidx)
    state = sp.load_state(str(work))
    qidx, offsets = sp.query_plan(state["tracks_target"], 16, 42)
    tracks = sp.corpus_tracks(args.corpus_seed, torch.device("cpu"))
    fields = ("song_name", "nb_matches_with_offset", "hashes_matched_in_input", "offset")
    for cond, params in sp.select_conditions(args.conditions).items():
        fp = sp.condition_augmenter(params, args) if params is not None else None
        correct = 0
        for _, tids, crops in sp.condition_batches(tracks, fp, qidx, offsets, 16):
            got = tdm.match_waveforms(crops)
            want = jdm.match_waveforms(crops.numpy())
            assert [{k: g.get(k) for k in fields} for g in got] == [
                {k: w.get(k) for k in fields} for w in want]
            correct += sum(ds.is_hit(w, t) for w, t in zip(want, tids))
        assert report["caps"][cap_str]["conditions"][cond]["accuracy"] == round(correct / 16, 4)
    assert report["caps"][cap_str]["conditions"]["cleans"]["accuracy"] >= 0.9


# ------------------------------------------------------------ big bank


def test_big_bank_train_one_step_on_the_cpu():
    out = big_bank_train.run(mb=4, batch=4, steps=1, device="cpu")
    assert out["big"]["bank_rows"] == 4 * 2**20 // (4 * 3 * SR)
    assert out["toy"]["bank_rows"] == big_bank_train.TOY_ROWS
    for line in (out["big"], out["toy"]):
        assert line["bank_resident"] and np.isfinite(line["loss"]) and line["step_ms"] > 0
        assert line["peak_mb"] is None  # measured on the card only
    assert out["big"]["bank_mb"] > out["toy"]["bank_mb"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        big_bank_train.run(mb=1, steps=1)


def test_scale_tables_run_both_systems_and_compare(tmp_path):
    """Both undenoised tables at a tiny size on the CPU, and the comparison
    with the JAX package's committed reports."""
    from musicfpaugment_torch.testing import scale_tables

    out = scale_tables.run([
        "--device", "cpu", "--tracks", "12", "--queries", "4", "--batch", "4", "--shifts", "1",
        "--banks", "toy", "--conditions", "cleans,bn_p10", "--workdir", str(tmp_path / "work"),
        "--out", str(tmp_path / "out")])
    assert sorted(os.listdir(tmp_path / "out")) == [
        "comparison.json", "dejavu_results.json", "results.json"]
    for system, keys in (("audfprint", scale_tables.TABLE_KEYS), ("dejavu", scale_tables.DEJAVU_KEYS)):
        assert set(out[system]) == {*keys, "accuracy"}
        assert set(out[system]["accuracy"]) == {"cleans", "bn_p10"}
        assert out[system]["accuracy"]["cleans"]["port"] == 1.0
    assert out["audfprint"]["total_hashes"]["jax"] == 100714127  # examples/scale_out/results.json
    assert out["dejavu"]["total_rows"]["port"] > 0

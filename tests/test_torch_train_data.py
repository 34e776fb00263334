"""The port's training data layer against the JAX package's: track loading,
segmentation and the silence filter, the segment pipeline and the pair
dataset, the MTG-Jamendo and DCASE metadata readers, the CLI's synthetic
fallbacks, and the runtime utilities. Every file is written by the test
(WAV, TSV, CSV); the datasets are not on this machine.

Tolerances: decoded and resampled audio within 1e-6 (both read 16-bit PCM
as x / 32768 and resample with scipy); segments, metadata, splits and
synthetic arrays equal.
"""

import json
import os
import random

import numpy as np
import pandas as pd
import pytest
import scipy.io.wavfile
import torch

from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
from musicfpaugment_torch.data import dataset as tds
from musicfpaugment_torch.data import dcase as tdcase
from musicfpaugment_torch.data import jamendo as tjam
from musicfpaugment_torch.train import parameters as tparams
from musicfpaugment_torch.train import train as ttrain
from musicfpaugment_torch.train import utils as tutils
from musicfpaugment_tpu.data import dataset as jds
from musicfpaugment_tpu.data import dcase as jdcase
from musicfpaugment_tpu.data import jamendo as jjam
from musicfpaugment_tpu.train import parameters as jparams
from musicfpaugment_tpu.train import train as jtrain

from torch_port_helpers import few_threads, music  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000


def _write_wav(path, seconds, sr=SR, channels=1, silent=(), seed=0, dtype=np.int16):
    """Multitone audio with silent stretches ``silent`` = [(start_s, end_s)]."""
    n = int(seconds * sr)
    x = music(channels, n, seed=seed).T * 4  # (n, channels)
    for a, b in silent:
        x[int(a * sr) : int(b * sr)] = 0.0
    if dtype == np.int16:
        x = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    scipy.io.wavfile.write(str(path), sr, x[:, 0] if channels == 1 else x)
    return str(path)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    paths = [
        _write_wav(d / "mono16k.wav", 7.3, sr=16000, seed=1, silent=[(3.5, 6.0)]),
        _write_wav(d / "stereo.wav", 9.0, channels=2, seed=2, dtype=np.float32),
        _write_wav(d / "cd.wav", 6.5, sr=44100, channels=2, seed=3),
    ]
    (d / "broken.wav").write_bytes(b"RIFF0000WAVEjunk")
    return paths, str(d / "broken.wav")


def test_load_track_matches_jax(wavs):
    paths, broken = wavs
    for path in paths:
        for mono, norm in ((True, True), (False, False)):
            got = tds.load_track(path, SR, mono=mono, do_norm=norm)
            want = jds.load_track(path, SR, mono=mono, do_norm=norm)
            assert got.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-6)
    # a file that does not decode reads as ten minutes of silence in both
    np.testing.assert_array_equal(tds.load_track(broken, SR), jds.load_track(broken, SR))
    assert tds.load_track(broken, SR).shape == (10 * 60 * SR,)


@pytest.mark.parametrize("step_fraction", [1.0, 0.5])
def test_segments_and_silence_filter_match_jax(wavs, step_fraction):
    audio = jds.load_track(wavs[0][0], SR)
    got = tds.segment_track(audio, 1.0, SR, step_fraction)
    want = jds.segment_track(audio, 1.0, SR, step_fraction)
    np.testing.assert_array_equal(got, want)
    kept = tds.select_no_silence_frames(audio, got)
    np.testing.assert_array_equal(kept, jds.select_no_silence_frames(audio, want))
    assert 0 < kept.shape[0] < got.shape[0]  # the silent stretch is dropped
    # natural-log "dBs": -7.5 natural-log dB is about -3.3 dB in log10 units
    rms = np.sqrt(np.mean(audio**2))
    quiet = np.stack([0.5 * audio[:SR] / np.sqrt(np.mean(audio[:SR] ** 2)) * rms])
    assert tds.select_no_silence_frames(audio, quiet).shape[0] == 1
    assert tds.segment_track(audio[: SR // 2], 1.0, SR).shape == (0, SR)
    assert tds.select_no_silence_frames(audio, np.zeros((0, SR), np.float32)).shape == (0, SR)


def _expected_segments(paths, seconds):
    out = []
    for p in paths:
        audio = jds.load_track(p, SR)
        out.append(jds.select_no_silence_frames(audio, jds.segment_track(audio, seconds, SR)))
    return np.concatenate(out)


def test_segment_pipeline_yields_segments_of_the_tracks(wavs):
    paths = wavs[0]
    expected = _expected_segments(paths, 1.0)
    pipe = tds.SegmentPipeline(paths, SR, duration_s=1.0, n_segments=3, batch_size=4,
                               buffer_size=8, num_workers=2, seed=5)
    try:
        it = iter(pipe)
        batches = [next(it) for _ in range(3)]
    finally:
        pipe.stop()
    for b in batches:
        assert b.shape == (4, SR) and b.dtype == np.float32
        for row in b:
            assert np.any(np.all(expected == row, axis=1))
    # the same path order as the JAX pipeline's feeder for the same seed
    order = list(paths)
    random.Random(5).shuffle(order)
    j_order = list(paths)
    jds.SegmentPipeline(paths, SR, seed=5)._rng.shuffle(j_order)
    assert order == j_order


def test_augmentation_dataset_pairs_on_the_cpu(wavs):
    noise_bank, ir_bank = synthetic_banks(SR, num_noise=4, num_irs=2, noise_row_length=SR, device="cpu")
    fp = AugmentFP(noise_bank, SR, impulse_response_dir=ir_bank, device="cpu")
    ds = tds.AugmentationDataset(wavs[0], SR, model_duration_seconds=1.0, n_segments=2,
                                 augmenter=fp, batch_size=3, num_workers=1)
    try:
        clean, aug = next(iter(ds))
    finally:
        ds.pipeline.stop()
    assert isinstance(aug, np.ndarray) and clean.shape == aug.shape == (3, SR)
    assert np.isfinite(aug).all()
    np.testing.assert_allclose(np.abs(aug).max(axis=1), 1.0, atol=1e-6)


# ------------------------------------------------------------ MTG-Jamendo


def _jamendo_tree(root):
    split = root / "data" / "splits" / "split-0"
    split.mkdir(parents=True)
    audio = root / "raw_30s" / "audio"
    header = "TRACK_ID\tARTIST_ID\tALBUM_ID\tPATH\tDURATION\tTAGS\n"
    rows = {"train": range(0, 6), "validation": range(6, 14), "test": range(14, 17)}
    for name, ids in rows.items():
        lines = [header]
        for i in ids:
            rel = f"{i % 3:02d}/{i}.wav"
            (audio / rel).parent.mkdir(parents=True, exist_ok=True)
            _write_wav(audio / rel, 4.0 + i % 3, seed=i)
            tags = ["genre---rock,pop", "instrument---guitar"] if i % 2 else ["mood/theme---happy"]
            lines.append("\t".join([f"track_{i:07d}", f"artist_{i // 2:06d}", f"album_{i // 3:06d}",
                                    rel, f"{200 + i}.5"] + tags) + "\n")
        (split / f"autotagging-{name}.tsv").write_text("".join(lines))
    return str(root)


def test_jamendo_readers_match_jax(tmp_path, monkeypatch):
    root = _jamendo_tree(tmp_path / "jamendo")
    tsv = os.path.join(root, "data", "splits", "split-0", "autotagging-train.tsv")
    assert tjam.read_file(tsv) == jjam.read_file(tsv)
    assert tjam.get_id("track_0001234") == 1234 and tjam.get_length([7, 1234]) == 4
    for num_val in (2, 5):
        got, want = tjam.get_jamendo_data(root, num_val), jjam.get_jamendo_data(root, num_val)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(got[1]) == num_val and len(got[0]) == 6 + 8 - num_val + 3

    monkeypatch.setattr(tjam, "TRAIN_BUFFER_SIZE", 8)
    monkeypatch.setattr(tjam, "VAL_BUFFER_SIZE", 8)
    train, val = tjam.get_data_loaders(batch_size=2, val_steps=1, dataset_path=root)
    assert next(train).shape == next(val).shape == (2, tparams.DURATION * SR)


# ------------------------------------------------------------ DCASE


def _dcase_tree(root):
    """The six DCASE metadata files with three scenes, one of them metro."""
    scenes = ["park", "metro", "bus"]

    def rows(n, offset):
        return [(f"audio/{offset + i}.wav", scenes[i % 3]) for i in range(n)]

    for path in (tparams.dcase_2017_dev_path, tparams.dcase_2017_eval_path):
        d = root / os.path.relpath(path, tparams._NOISE_ROOT)
        d.mkdir(parents=True)
        off = 0 if "development" in path else 500
        (d / "meta.txt").write_text("".join(f"{f}\t{s}\tloc{i % 4}\n" for i, (f, s) in enumerate(rows(150, off))))
    for path, off in ((tparams.dcase_2018_dev_path, 1000), (tparams.dcase_2020_dev_path, 2000)):
        d = root / os.path.relpath(path, tparams._NOISE_ROOT)
        d.mkdir(parents=True)
        lines = ["filename\tscene_label\tidentifier\tsource_label\n"]
        lines += [f"{f}\t{s}\tid{i % 5}\t{'abc'[i % 3]}\n" for i, (f, s) in enumerate(rows(400, off))]
        (d / "meta.csv").write_text("".join(lines))
    d = root / os.path.relpath(tparams.dcase_2018_eval_path, tparams._NOISE_ROOT) / "evaluation_setup"
    d.mkdir(parents=True)
    (d / "test.txt").write_text("".join(f"{f}\n" for f, _ in rows(20, 3000)))
    d = root / os.path.relpath(tparams.dcase_2020_eval_path, tparams._NOISE_ROOT) / "evaluation_setup"
    d.mkdir(parents=True)
    (d / "fold1_test.csv").write_text("filename\n" + "".join(f"{f}\n" for f, _ in rows(20, 4000)))


def test_dcase_metadata_and_splits_match_jax(tmp_path, monkeypatch):
    _dcase_tree(tmp_path)
    for name in ("dcase_2017_dev_path", "dcase_2017_eval_path", "dcase_2018_dev_path",
                 "dcase_2018_eval_path", "dcase_2020_dev_path", "dcase_2020_eval_path"):
        rel = os.path.relpath(getattr(tparams, name), tparams._NOISE_ROOT)
        assert rel == os.path.relpath(getattr(jparams, name), jparams._NOISE_ROOT)
        monkeypatch.setattr(tdcase, name, str(tmp_path / rel) + "/")
        monkeypatch.setattr(jdcase, name, str(tmp_path / rel) + "/")
    got, want = tdcase.get_dcase_union(), jdcase.get_dcase_union()
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 150 * 2 + 134 * 2 + 20 * 2  # device 'a' only in the 2018/2020 dev sets

    t_ds, j_ds = tdcase.NoiseDataset("union"), jdcase.NoiseDataset("union")
    for ds in (t_ds, j_ds):
        ds.drop("scene_label", "metro")
        ds.filter_dataset([{"column": "location", "operator": "equals", "value": "loc1"}])
    pd.testing.assert_frame_equal(t_ds.dataset, j_ds.dataset)
    assert set(t_ds.get_classes()) == {"park", "bus"}

    for pkg, mod in (("port", tdcase), ("jax", jdcase)):
        random.seed(11)
        mod.build_splits(str(tmp_path / pkg))
    for split in ("train", "val", "test"):
        t_json = json.loads((tmp_path / "port" / f"{split}.json").read_text())
        j_json = json.loads((tmp_path / "jax" / f"{split}.json").read_text())
        assert t_json == j_json and set(t_json) == {"park", "bus"}
    assert len(t_json["park"]) == 100  # 20 val / 100 test / rest train
    monkeypatch.setattr(tdcase, "SPLITS_DIR", str(tmp_path / "port"))
    assert tdcase.load_noise_split("val") == json.loads((tmp_path / "jax" / "val.json").read_text())


# ------------------------------------------------------------ fallbacks, utils


def test_cli_falls_back_to_the_jax_packages_synthetic_data():
    t_train, t_val = ttrain.build_data(2, SR, 1)
    j_train, j_val = jtrain.build_data(2, SR, 1)
    for t_it, j_it in ((t_train, j_train), (t_val, j_val)):
        for _ in range(2):
            np.testing.assert_array_equal(next(t_it), next(j_it))
    t_fp, j_fp = ttrain.build_augmenter(SR, "cpu"), jtrain.build_augmenter(SR)
    np.testing.assert_array_equal(t_fp.noise_bank.clips.numpy(), np.asarray(j_fp.noise_bank.clips))
    np.testing.assert_array_equal(t_fp.ir_bank.irs.numpy(), np.asarray(j_fp.ir_bank.irs))
    assert t_fp.noise_bank.row_length == tparams.DURATION * SR


def test_parameters_are_the_jax_packages():
    names = [n for n in dir(jparams) if n.isupper() or n.startswith("dcase_")]
    assert len(names) > 20
    for name in names:
        if name != "CKPT_PATH":
            assert getattr(tparams, name) == getattr(jparams, name), name
    assert tparams.CKPT_PATH.endswith(os.path.join("musicfpaugment_torch", "train", "checkpoints",
                                                   "unet_lr_0.001_BS_128"))


def test_runtime_utilities(tmp_path):
    tutils.fix_random_seeds(7)
    a = (np.random.rand(3), torch.rand(3))
    tutils.fix_random_seeds(7)
    np.testing.assert_array_equal(np.random.rand(3), a[0])
    assert torch.equal(torch.rand(3), a[1])
    assert tutils.get_rank() == 0 and tutils.get_world_size() == 1 and tutils.is_main_process()
    assert not tutils.is_dist_avail_and_initialized()
    assert tutils.set_gpus() == tutils.set_devices() == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    cache = tmp_path / "validation_set_cache"
    cache.mkdir()
    (tmp_path / "validation_set_cache.index").write_text("x")
    tutils.remove_val_cache(str(cache))
    assert os.listdir(tmp_path) == []

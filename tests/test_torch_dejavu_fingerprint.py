"""Dejavu fingerprinting, port against the JAX package on the CPU.

Tolerances: the PSD spectrogram within 1e-5 of its largest value. The log
spectrogram within 1e-5 of its largest magnitude from the same function in
float64, and within 2e-5 from JAX's: ln() turns the FFT's float32 rounding
at the floor cells (1e-6 of the max) into absolute errors, and each package
lies 6e-6 to 9e-6 from float64 on these inputs. Peak masks
from the same log spectrogram bit-identical (max and AND are exact); masks
from the same waveforms equal in >= 0.999 of cells; hashes, packed hashes
and their device packing bit-identical from the same masks.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch import convert
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_tpu.models import UNet as JUNet

from torch_port_helpers import few_threads, flax_unet_variables, port_unet, rel_err  # noqa: F401

tf = importlib.import_module("musicfpaugment_torch.afp.dejavu.fingerprint")
jf = importlib.import_module("musicfpaugment_tpu.afp.dejavu.fingerprint")

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
FROM_WAVEFORM_AGREEMENT = 0.999


def _waves(batch=3, seconds=3.0, seed=31):
    x = next(synthetic_clean_batches(batch, int(seconds * SR), seed=seed, sample_rate=SR))
    return x * 32767.0


def _log_spectrograms(rng, shape, plateaus=False, zero_background=False):
    arr = (rng.standard_normal(shape) * 40).astype(np.float32)
    if plateaus:  # few levels: equal neighbours in a window are common
        arr = np.round(arr / 25) * 25
    if zero_background:
        arr[..., : shape[-2] // 3, :] = 0
        arr[..., :, shape[-1] // 2 :] = 0
    return arr


def test_specgram_psd_matches_jax():
    x = _waves()
    got = tf.specgram_psd(torch.from_numpy(x))
    want = np.asarray(jf.specgram_psd(jnp.asarray(x)))
    assert got.dtype == torch.float32 and got.shape == want.shape == (3, 257, 92)
    assert rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("plateaus", [False, True])
@pytest.mark.parametrize("zero_background", [False, True])
@pytest.mark.parametrize("shape", [(257, 120), (3, 64, 50), (2, 2, 40, 33), (12, 9)])
def test_detect_peaks_mask_bit_identical(shape, plateaus, zero_background):
    rng = np.random.default_rng(hash((shape, plateaus, zero_background)) % 2**32)
    arr = _log_spectrograms(rng, shape, plateaus, zero_background)
    got = tf.detect_peaks_mask(torch.from_numpy(arr), amp_min=30)
    want = np.asarray(jf.detect_peaks_mask(jnp.asarray(arr), amp_min=30))
    assert got.dtype == torch.bool and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_detect_peaks_mask_other_neighborhood_and_connectivity():
    arr = _log_spectrograms(np.random.default_rng(3), (2, 50, 40), plateaus=True)
    got = tf.detect_peaks_mask(torch.from_numpy(arr), amp_min=10, neighborhood=3)
    want = np.asarray(jf.detect_peaks_mask(jnp.asarray(arr), amp_min=10, neighborhood=3))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="connectivity"):
        tf.detect_peaks_mask(torch.from_numpy(arr), connectivity=1)


def test_fingerprint_spectrogram_batch_matches_jax():
    x = _waves(batch=4, seconds=4.0, seed=32)
    logd, mask, sgram = tf.fingerprint_spectrogram_batch(torch.from_numpy(x))
    j_logd, j_mask, j_sgram = (np.asarray(a) for a in jf.fingerprint_spectrogram_batch(jnp.asarray(x)))
    f64 = tf.fingerprint_spectrogram_batch(torch.from_numpy(x).double())[0].numpy()
    assert rel_err(logd.numpy(), f64) <= 1e-5
    assert rel_err(logd.numpy(), j_logd) <= 2e-5
    assert rel_err(sgram.numpy(), j_sgram) <= 1e-5
    assert (mask.numpy() == j_mask).mean() >= FROM_WAVEFORM_AGREEMENT
    assert j_mask.sum() > 100
    # from the same log spectrogram the masks are bit-identical
    np.testing.assert_array_equal(
        tf.detect_peaks_mask(torch.from_numpy(np.array(j_logd))).numpy(), j_mask
    )


def test_silent_rows_give_no_peaks():
    x = _waves(batch=2)
    x[1] = 0
    logd, mask, sgram = tf.fingerprint_spectrogram_batch(torch.from_numpy(x))
    _, j_mask, _ = jf.fingerprint_spectrogram_batch(jnp.asarray(x))
    np.testing.assert_array_equal(mask[1].numpy(), np.asarray(j_mask)[1])
    assert not mask[1].any() and mask[0].any()


def test_denoiser_hook_matches_jax():
    """A seeded small UNet as the spectrogram hook, weights carried across."""
    jm = JUNet(1, 1, base=8)
    params, stats = flax_unet_variables(jm, (1, 16, 16), seed=13)
    variables = {"params": params, "batch_stats": stats}
    j_hook = lambda s: jm.apply(variables, s, train=False).astype(jnp.float32)  # noqa: E731
    t_hook = convert.unet_denoiser(port_unet(params, stats))
    x = _waves(batch=2, seconds=3.0, seed=33)
    logd, mask, sgram = tf.fingerprint_spectrogram_batch(torch.from_numpy(x), denoiser=t_hook)
    j_logd, j_mask, j_sgram = (
        np.asarray(a) for a in jf.fingerprint_spectrogram_batch(jnp.asarray(x), denoiser=j_hook)
    )
    assert rel_err(sgram.numpy(), j_sgram) <= 1e-5
    assert rel_err(logd.numpy(), j_logd) <= 2e-5
    assert (mask.numpy() == j_mask).mean() >= FROM_WAVEFORM_AGREEMENT
    _, plain, _ = tf.fingerprint_spectrogram_batch(torch.from_numpy(x))
    assert (mask != plain).any()  # the hook did something


def _masks(rng, B=3, F=64, C=80, p=0.03):
    masks = rng.random((B, F, C)) < p
    masks[1] = False  # an empty query
    return masks


def test_generate_and_pack_hashes_bit_identical():
    masks = _masks(np.random.default_rng(5))
    masks[2, 3, 0] = masks[2, 9, 230 % 80] = True
    for m in masks:
        peaks = tf.peaks_from_mask(m)
        assert peaks == jf.peaks_from_mask(m)
        assert tf.generate_hashes(peaks) == jf.generate_hashes(peaks)
        assert tf.pack_hashes(peaks) == jf.pack_hashes(peaks)
        assert tf.generate_hashes(peaks, fan_value=5) == jf.generate_hashes(peaks, fan_value=5)
    # the time-delta limit (> 200 frames is not a pair)
    peaks = [(10, 0), (20, 1), (15, 3), (30, 250)]
    assert tf.generate_hashes(peaks) == jf.generate_hashes(peaks)
    assert tf.pack_hashes(peaks) == jf.pack_hashes(peaks)


@pytest.mark.parametrize("max_peaks,fan_value", [(256, 3), (16, 3), (128, 5)])
def test_pack_hashes_from_masks_bit_identical(max_peaks, fan_value):
    masks = _masks(np.random.default_rng(max_peaks + fan_value))
    got = tf.pack_hashes_from_masks(torch.from_numpy(masks), max_peaks, fan_value)
    want = jf.pack_hashes_from_masks(jnp.asarray(masks), max_peaks, fan_value)
    names = ("keys", "t1", "valid", "key_first", "n_distinct", "n_peak_overflow")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    n_peaks = masks.reshape(masks.shape[0], -1).sum(axis=1)
    assert int(got[5]) == int((n_peaks > max_peaks).sum())
    if max_peaks == 16:
        assert int(got[5]) == 2
    # the host set() of pack_hashes, row by row
    keys, t1, valid, key_first, n_distinct = (a.numpy() for a in got[:5])
    for b in range(masks.shape[0]):
        if n_peaks[b] > max_peaks:
            continue  # a truncated row keeps its first max_peaks peaks only
        host = set(tf.pack_hashes(tf.peaks_from_mask(masks[b]), fan_value=fan_value))
        assert {(int(k), int(t)) for k, t, v in zip(keys[b], t1[b], valid[b]) if v} == host
        assert n_distinct[b] == len(host)
        assert key_first[b].sum() == len({k for k, _ in host})


def test_pack_hashes_from_masks_injectivity_guards(monkeypatch):
    with pytest.raises(ValueError, match="512 frequency bins"):
        tf.pack_hashes_from_masks(torch.zeros((1, 513, 4), dtype=torch.bool), 8)
    with pytest.raises(ValueError, match="512 frequency bins"):
        jf.pack_hashes_from_masks(jnp.zeros((1, 513, 4), bool), 8)
    monkeypatch.setattr(tf, "MAX_HASH_TIME_DELTA", 256)
    monkeypatch.setattr(jf, "MAX_HASH_TIME_DELTA", 256)
    for mod, zeros in ((tf, torch.zeros((1, 8, 4), dtype=torch.bool)), (jf, jnp.zeros((1, 8, 4), bool))):
        with pytest.raises(ValueError, match="MAX_HASH_TIME_DELTA"):
            mod.pack_hashes_from_masks(zeros, 8)


def test_fingerprint_and_get_2D_peaks_match_jax():
    x = _waves(batch=1, seconds=2.0, seed=34)[0]
    got = tf.fingerprint(x, amp_min=10, device="cpu")
    want = jf.fingerprint(x, amp_min=10)
    assert len(want) > 0
    assert len(set(got) ^ set(want)) <= 0.01 * len(want)
    h, mask, sgram = tf.fingerprint(x, amp_min=10, get_masks=True, device="cpu")
    jh, jmask, jsgram = jf.fingerprint(x, amp_min=10, get_masks=True)
    assert mask.dtype == np.float64 and mask.shape == jmask.shape == (257, 61)
    assert sgram.shape == jsgram.shape and rel_err(sgram, jsgram) <= 1e-5
    assert (mask == jmask).mean() >= FROM_WAVEFORM_AGREEMENT
    arr = _log_spectrograms(np.random.default_rng(8), (60, 45), plateaus=True)
    peaks, m = tf.get_2D_peaks(arr, device="cpu")
    j_peaks, jm = jf.get_2D_peaks(arr)
    assert peaks == j_peaks and m.dtype == np.float64
    np.testing.assert_array_equal(m, jm)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.fingerprint(np.zeros(1024, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.get_2D_peaks(np.zeros((10, 10), np.float32))

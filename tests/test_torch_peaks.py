"""Port parity: musicfpaugment_torch.afp.audfprint.peaks (frontends, plain
prunes, find_peaks_batch) against the JAX package. The CUDA kernels are
held against these plain versions on the card in test_torch_cuda.py.

The prunes are compared on the SAME log spectrogram, where the plain loops
do the JAX scan's IEEE operations in the same order: equality is expected,
and agreement >= 0.9999 of cells (the JAX package's own Pallas-vs-scan
bound, tests/test_audfprint.py) is asserted. From waveforms, the FFTs of the
two packages round differently at ~1e-6, which can flip a near-tie cell:
agreement >= 0.999 of cells is asserted there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import gaussian_filter

from musicfpaugment_tpu.afp.audfprint import peaks as jp
from musicfpaugment_tpu.afp.audfprint.analyzer import (
    pad_waveform_batch as j_pad_waveform_batch,
)
from musicfpaugment_tpu.afp.audfprint.peaks_pallas import (
    backward_prune_pallas,
    forward_prune_pallas,
)
from musicfpaugment_torch.afp.audfprint import peaks as tp
from musicfpaugment_torch.afp.audfprint import peaks_cuda
from musicfpaugment_torch.afp.audfprint.analyzer import (
    pad_waveform_batch,
    valid_frames_for,
)

A_DEC = tp.prune_decay(20.0, 256)
SAME_INPUT_AGREEMENT = 0.9999
FROM_WAVEFORM_AGREEMENT = 0.999
FRONTEND_RTOL = 1e-5  # of the max magnitude: float32 FFT rounding


def _logsg(seed, B, F, C):
    x = gaussian_filter(
        np.random.default_rng(seed).standard_normal((B, F, C)), sigma=(0, 2.0, 1.5)
    ).astype(np.float32) * 3
    return x - x.mean(axis=(1, 2), keepdims=True)


def _close(got, want, rtol=FRONTEND_RTOL):
    got, want = np.array(got), np.array(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= rtol, err


def test_locmax_and_gauss_table_match_jax():
    v = np.random.default_rng(0).integers(0, 4, (6, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        tp._locmax(torch.from_numpy(v)).numpy(), np.array(jp._locmax(jnp.array(v)))
    )
    np.testing.assert_array_equal(tp._gauss_table_np(256, 30.0), jp._gauss_table_np(256, 30.0))


@pytest.mark.parametrize("with_valid", [False, True])
def test_frontends_match_jax(with_valid):
    x = np.random.default_rng(0).standard_normal((3, 16000)).astype(np.float32)
    vf = np.array([63, 40, 55], np.int32) if with_valid else None
    tvf = None if vf is None else torch.from_numpy(vf)
    jvf = None if vf is None else jnp.array(vf)
    s_t = tp.spectrogram_frontend(torch.from_numpy(x), valid_frames=tvf)
    s_j = jp.spectrogram_frontend(jnp.array(x), valid_frames=jvf)
    _close(s_t.numpy(), s_j)
    # the log-HPF frontend on the same spectrogram
    l_t = tp.log_hpf_frontend(torch.from_numpy(np.array(s_j)), tvf)
    _close(l_t.numpy(), jp.log_hpf_frontend(s_j, jvf))


# (seed, B, F, C): a query-like block, and C=600 across the Pallas kernel's
# 256-column tiles with a ragged tail
@pytest.mark.parametrize("seed,B,F,C", [(3, 4, 128, 60), (11, 2, 256, 600)])
def test_plain_prunes_match_jax_scan_and_pallas(seed, B, F, C):
    x = _logsg(seed, B, F, C)
    xj = jnp.array(x)
    f_t = tp.forward_prune(torch.from_numpy(x), A_DEC, 30.0, 5).numpy()
    f_scan = np.array(jp.forward_prune(xj, A_DEC, 30.0, 5))
    f_pal = np.array(forward_prune_pallas(xj, A_DEC, 30.0, 5, interpret=True))
    assert f_t.sum() > 0
    assert (f_t == f_scan).mean() >= SAME_INPUT_AGREEMENT
    assert (f_t == f_pal).mean() >= SAME_INPUT_AGREEMENT

    fj = jnp.array(f_scan)
    b_t = tp.backward_prune(
        torch.from_numpy(x), torch.from_numpy(f_scan), A_DEC, 30.0, 5
    ).numpy()
    b_scan = np.array(jp.backward_prune(xj, fj, A_DEC, 30.0, 5))
    b_pal = np.array(backward_prune_pallas(xj, fj, A_DEC, 30.0, 5, interpret=True))
    assert b_t.sum() > 0
    assert (b_t == b_scan).mean() >= SAME_INPUT_AGREEMENT
    assert (b_t == b_pal).mean() >= SAME_INPUT_AGREEMENT


def test_plain_backward_prune_mixed_valid_frames_matches_jax():
    x = _logsg(5, 4, 128, 90)
    vf = np.array([90, 41, 77, 12], np.int32)
    colmask = np.arange(90)[None, None, :] < vf[:, None, None]
    x = np.where(colmask, x, -1e30).astype(np.float32)
    f_scan = np.array(jp.forward_prune(jnp.array(x), A_DEC, 30.0, 5)) & colmask
    f_t = tp.forward_prune(torch.from_numpy(x), A_DEC, 30.0, 5).numpy() & colmask
    assert (f_t == f_scan).mean() >= SAME_INPUT_AGREEMENT
    b_t = tp.backward_prune(
        torch.from_numpy(x), torch.from_numpy(f_scan), A_DEC, 30.0, 5,
        torch.from_numpy(vf),
    ).numpy()
    b_j = np.array(jp.backward_prune(
        jnp.array(x), jnp.array(f_scan), A_DEC, 30.0, 5, jnp.array(vf)
    ))
    assert b_t.sum() > 0
    assert (b_t == b_j).mean() >= SAME_INPUT_AGREEMENT


def test_find_peaks_batch_from_waveforms_matches_jax():
    x = np.random.default_rng(4).standard_normal((3, 3 * 8000)).astype(np.float32)
    before = dict(peaks_cuda.LAUNCHES)
    got = tp.find_peaks_batch(torch.from_numpy(x)).numpy()
    want = np.array(jp.find_peaks_batch(jnp.array(x)))
    assert got.shape == want.shape and got.sum() > 0
    assert (got == want).mean() >= FROM_WAVEFORM_AGREEMENT
    # CPU tensors take the plain prunes: no kernel launch was counted
    assert peaks_cuda.LAUNCHES == before


def test_find_peaks_batch_mixed_lengths_matches_jax():
    r = np.random.default_rng(8)
    wavs = [r.standard_normal(n).astype(np.float32) for n in (16000, 11000, 13500)]
    batch, lens = pad_waveform_batch(wavs)
    j_batch, j_lens = j_pad_waveform_batch(wavs)
    np.testing.assert_array_equal(batch.numpy(), j_batch)
    np.testing.assert_array_equal(lens, j_lens)
    vf = valid_frames_for(lens.astype(np.int64)).astype(np.int32)
    got = tp.find_peaks_batch(batch, valid_frames=torch.from_numpy(vf)).numpy()
    want = np.array(jp.find_peaks_batch(jnp.array(j_batch), valid_frames=jnp.array(vf)))
    assert (got == want).mean() >= FROM_WAVEFORM_AGREEMENT
    for b, n in enumerate(vf):
        assert not got[b, :, n:].any()  # nothing past a row's valid frames


def test_cuda_wrappers_reject_cpu_tensors():
    x = torch.zeros((1, 256, 8))
    with pytest.raises(ValueError):
        peaks_cuda.forward_prune_cuda(x, A_DEC)
    with pytest.raises(ValueError):
        peaks_cuda.backward_prune_cuda(x, x.bool(), A_DEC)

"""Port parity: musicfpaugment_torch.core against musicfpaugment_tpu.core.

Inputs are made with numpy from a seed and handed to both packages. FFTs run
through pocketfft (torch) and XLA's CPU FFT (JAX), whose float32 rounding
differs at ~1e-6 of the peak, so results are compared after dividing by the
reference's largest magnitude, at 1e-5.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.core import convolve as tconv
from musicfpaugment_torch.core import stft as tstft

# the JAX package's core/__init__ re-exports functions under the module names
jconv = importlib.import_module("musicfpaugment_tpu.core.convolve")
jstft = importlib.import_module("musicfpaugment_tpu.core.stft")

RTOL = 1e-5  # of the max magnitude: float32 FFT rounding, two FFT libraries


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, err


def test_periodic_hann_identical():
    np.testing.assert_array_equal(tstft.periodic_hann(512), jstft.periodic_hann(512))


def test_frame_matches_jax():
    x = np.arange(2 * 3000, dtype=np.float32).reshape(2, 3000)
    got = tstft.frame(torch.from_numpy(x), 512, 256).numpy()
    np.testing.assert_array_equal(got, np.asarray(jstft.frame(jnp.asarray(x), 512, 256)))


@pytest.mark.parametrize("n_samples", [8000, 12345])
def test_stft_matches_jax(n_samples):
    x = np.random.default_rng(0).standard_normal((3, n_samples)).astype(np.float32)
    got = tstft.stft(torch.from_numpy(x), n_fft=512, hop_length=256).numpy()
    want = np.asarray(jstft.stft(jnp.asarray(x), n_fft=512, hop_length=256))
    _close(got.real, want.real)
    _close(got.imag, want.imag)


@pytest.mark.parametrize("per_example", [False, True])
def test_magnitude_spectrogram_matches_jax(per_example):
    x = np.random.default_rng(1).standard_normal((2, 16000)).astype(np.float32)
    x[1] *= 0.1
    got = tstft.magnitude_spectrogram(torch.from_numpy(x), per_example=per_example)
    want = jstft.magnitude_spectrogram(jnp.asarray(x), per_example=per_example)
    _close(got.numpy(), want)


# (m, n): single-shot (n comparable to m) and overlap-save (n << m) sizes
@pytest.mark.parametrize("m,n", [(251, 251), (1000, 37), (20000, 113), (50, 300)])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fft_convolve_matches_jax(m, n, mode):
    r = np.random.default_rng(m + n)
    x = r.standard_normal((2, m)).astype(np.float32)
    k = r.standard_normal(n).astype(np.float32)
    got = tconv.fft_convolve(torch.from_numpy(x), torch.from_numpy(k), mode=mode)
    want = jconv.fft_convolve(jnp.asarray(x), jnp.asarray(k), mode=mode)
    _close(got.numpy(), want)


def test_overlap_save_path_is_taken():
    """The cost model picks overlap-save for a short kernel, the same chunk
    in both packages, and the result equals numpy's direct convolution."""
    assert tconv._os_chunk_size(20000, 113) < tconv.next_pow2(20000 + 112)
    assert tconv._os_chunk_size(20000, 113) == jconv._os_chunk_size(20000, 113)
    r = np.random.default_rng(7)
    x = r.standard_normal(20000).astype(np.float32)
    k = r.standard_normal(113).astype(np.float32)
    got = tconv.fft_convolve(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    _close(got, np.convolve(x.astype(np.float64), k.astype(np.float64)))

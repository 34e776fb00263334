"""The port's training losses and spectrogram frontend against JAX's on the
same arrays (CPU; JAX's ``stft_magnitude`` on its rfft route).

Tolerances: every loss and magnitude within 1e-5 relative (two FFT
libraries round differently at ~1e-7); the gradient of the MR-STFT loss
with respect to ``x`` (``jax.grad`` against autograd) within 1e-9 of its
largest value in float64 and 1e-3 in float32, where the log-magnitude term
amplifies the rounding of small bins (see the test); ``spectrogram_batch``
within 1e-5 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.train import losses as tl
from musicfpaugment_torch.train.trainer import spectrogram_batch
from musicfpaugment_tpu.train import losses as jl
from musicfpaugment_tpu.train.trainer import spectrogram_batch as j_spectrogram_batch

from torch_port_helpers import few_threads, music, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

RESOLUTIONS = [(1024, 120, 600), (2048, 240, 1200), (512, 50, 240)]


def _pair(seed=0, batch=3, samples=8000):
    """A clean batch and a noisy version of it."""
    x = music(batch, samples, seed=seed)
    noise = np.random.default_rng(seed + 10).standard_normal(x.shape).astype(np.float32)
    return (x + 0.05 * noise).astype(np.float32), x


def _rel(got, want):
    got, want = float(got), float(want)
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("fft_size,hop,win", RESOLUTIONS)
def test_stft_magnitude_matches_jax(fft_size, hop, win):
    np.testing.assert_array_equal(
        tl._torch_hann_padded(win, fft_size), jl._torch_hann_padded(win, fft_size))
    x, _ = _pair()
    got = tl.stft_magnitude(torch.from_numpy(x), fft_size, hop, win).numpy()
    want = np.asarray(jl.stft_magnitude(jnp.asarray(x), fft_size, hop, win, use_matmul=False))
    assert got.shape == want.shape == (3, 1 + 8000 // hop, fft_size // 2 + 1)
    assert rel_err(got, want) <= 1e-5
    assert got.min() >= np.sqrt(1e-7) * 0.999


@pytest.mark.parametrize("fft_size,hop,win", RESOLUTIONS)
def test_stft_loss_terms_match_jax(fft_size, hop, win, monkeypatch):
    monkeypatch.setenv("MFPA_STFT_MATMUL", "0")
    x, y = _pair(1)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    got = tl.stft_loss(tx, ty, fft_size, hop, win)
    want = jl.stft_loss(jx, jy, fft_size, hop, win)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    xm = tl.stft_magnitude(tx, fft_size, hop, win)
    ym = tl.stft_magnitude(ty, fft_size, hop, win)
    assert _rel(tl.spectral_convergence_loss(xm, ym),
                jl.spectral_convergence_loss(jnp.asarray(xm.numpy()), jnp.asarray(ym.numpy()))) <= 1e-5
    assert _rel(tl.log_stft_magnitude_loss(xm, ym),
                jl.log_stft_magnitude_loss(jnp.asarray(xm.numpy()), jnp.asarray(ym.numpy()))) <= 1e-5


@pytest.mark.parametrize("factors", [{}, {"factor_sc": 0.5, "factor_mag": 0.5}],
                         ids=["function_defaults", "cli_factors"])
def test_multi_resolution_stft_loss_matches_jax(factors, monkeypatch):
    monkeypatch.setenv("MFPA_STFT_MATMUL", "0")
    x, y = _pair(2)
    got = tl.multi_resolution_stft_loss(torch.from_numpy(x), torch.from_numpy(y), **factors)
    want = jl.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y), **factors)
    for g, w in zip(got, want):
        assert _rel(g, w) <= 1e-5
    if not factors:  # the function's own default is 0.1, not the CLI's 0.5
        half = tl.multi_resolution_stft_loss(
            torch.from_numpy(x), torch.from_numpy(y), factor_sc=0.5, factor_mag=0.5)
        assert _rel(half[0], 5 * got[0]) <= 1e-6


def test_l1_loss_matches_jax():
    x, y = _pair(3)
    assert _rel(tl.l1_loss(torch.from_numpy(x), torch.from_numpy(y)),
                jl.l1_loss(jnp.asarray(x), jnp.asarray(y))) <= 1e-5


@pytest.mark.parametrize("dtype,limit", [(np.float64, 1e-9), (np.float32, 1e-3)],
                         ids=["float64", "float32"])
def test_multi_resolution_stft_loss_gradient_matches_jax(dtype, limit, monkeypatch):
    """In float64 both gradients agree to ~1e-12. In float32 each lies ~3e-4
    of the largest value from a float64 run (the log-magnitude term divides
    by |X|, and bins near the 1e-7 floor carry the rounding of the frame's
    largest bin), so there the limit is 1e-3."""
    monkeypatch.setenv("MFPA_STFT_MATMUL", "0")
    x, y = (a.astype(dtype) for a in _pair(4, batch=2))

    def j_total(xx):
        sc, mag = jl.multi_resolution_stft_loss(xx, jnp.asarray(y), factor_sc=0.5, factor_mag=0.5)
        return sc + mag

    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax.grad(j_total)(jnp.asarray(x)))
    assert want.dtype == dtype
    tx = torch.from_numpy(x).requires_grad_(True)
    sc, mag = tl.multi_resolution_stft_loss(tx, torch.from_numpy(y), factor_sc=0.5, factor_mag=0.5)
    (sc + mag).backward()
    assert np.abs(want).max() > 0
    assert rel_err(tx.grad.numpy(), want) <= limit


@pytest.mark.parametrize("shape", [(4, 8000), (2, 24000)])
def test_spectrogram_batch_matches_jax(shape):
    x = music(*shape, seed=5)
    x[0] *= 0.01  # per-example max: a quiet example is scaled by its own max
    got = spectrogram_batch(torch.from_numpy(x)).numpy()
    want = np.asarray(j_spectrogram_batch(jnp.asarray(x)))
    assert got.shape == want.shape == (shape[0], 257, 1 + shape[1] // 256)
    assert rel_err(got, want) <= 1e-5
    np.testing.assert_allclose(got.max(axis=(1, 2)), 1.0, rtol=1e-6)

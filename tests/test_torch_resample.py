"""The port's sinc resampling against the JAX package's (CPU).

Tolerance: 1e-6 of the largest output (float32 sums of 112 products in
another order); the kernel taps equal to float32 rounding. 44.1 kHz -> 8 kHz
sums 123,921 taps per output: there both packages lie ~1.3e-6 from a float64
run of the same kernels, so the limit is 2e-6, against JAX and against
float64.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.core import resample as tr

from torch_port_helpers import few_threads, rel_err  # noqa: F401

jr = importlib.import_module("musicfpaugment_tpu.core.resample")

pytestmark = pytest.mark.usefixtures("few_threads")

TOL = 1e-6
LONG_KERNEL_TOL = 2e-6


def _signal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_kernel_taps_equal_jax():
    got, want = tr._kernel_updown2(), jr._kernel_updown2()
    assert got.shape == want.shape == (112,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=np.finfo(np.float32).eps)
    np.testing.assert_array_equal(got, got[::-1])  # symmetric: correlation = convolution


@pytest.mark.parametrize("shape", [(1001,), (3, 1000), (2, 3, 777), (2, 1, 2, 64)],
                         ids=["1d", "2d_even", "3d_odd", "4d_even"])
@pytest.mark.parametrize("fn", ["upsample2", "downsample2"])
def test_x2_pair_matches_jax(shape, fn):
    x = _signal(shape, len(shape) + shape[-1])
    got = getattr(tr, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(getattr(jr, fn))(jnp.asarray(x)))
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL


def test_x4_round_trip_keeps_a_band_limited_signal():
    t = np.arange(4000) / 8000.0
    x = np.sin(2 * np.pi * 440 * t).astype(np.float32)[None]
    up = tr.upsample2(tr.upsample2(torch.from_numpy(x)))
    assert up.shape == (1, 16000)
    back = tr.downsample2(tr.downsample2(up)).numpy()
    assert np.abs(back - x)[:, 200:-200].max() < 1e-3


@pytest.mark.parametrize("old,new", [(8000, 16000), (16000, 8000), (44100, 8000), (8000, 8000)])
@pytest.mark.parametrize("shape", [(2, 4410), (3, 1, 881)], ids=["2d", "3d"])
def test_resample_frac_matches_jax(old, new, shape):
    x = _signal(shape, old // 100 + new // 100)
    got = tr.resample_frac(torch.from_numpy(x), old, new)
    want = np.asarray(jr.resample_frac(jnp.asarray(x), old, new))
    assert tuple(got.shape) == want.shape == shape[:-1] + (int(np.ceil(shape[-1] * new / old)),)
    tol = LONG_KERNEL_TOL if old == 44100 else TOL
    assert rel_err(got.numpy(), want) <= tol
    exact = tr.resample_frac(torch.from_numpy(x).double(), old, new)
    assert rel_err(got.numpy(), exact.numpy()) <= tol
    if old == new:
        assert torch.equal(got, torch.from_numpy(x))

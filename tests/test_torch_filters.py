"""Port parity: musicfpaugment_torch.core filters, utils and noise against
musicfpaugment_tpu.core.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the filter taps are float32 closed forms whose ``sin``/``cos``
round differently in XLA and in PyTorch (abs 1e-6); filtered signals go
through two convolution libraries (1e-5 of the reference's largest
magnitude).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.core import filters as tfilt
from musicfpaugment_torch.core import noise as tnoise
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.core import utils as tutils
from torch_port_helpers import music, rel_err

jfilt = importlib.import_module("musicfpaugment_tpu.core.filters")
jutils = importlib.import_module("musicfpaugment_tpu.core.utils")

SR = 8000
KERNEL_ATOL = 1e-6
SIGNAL_RTOL = 1e-5

# cutoffs (fractions of sr) away from the points where zeros / c / 2 is an
# integer, which could flip one tap in or out between the libraries
CUTOFFS = np.asarray([0.0, 0.0037, 0.011, 0.0173, 0.123, 0.377, 0.4999], np.float32)


@pytest.mark.parametrize("half_size_max", [16, 256, 2048])
def test_lowpass_kernels_match_jax(half_size_max):
    got = tfilt.lowpass_kernels(torch.from_numpy(CUTOFFS), half_size_max).numpy()
    want = np.asarray(jfilt.lowpass_kernels(jnp.asarray(CUTOFFS), half_size_max))
    assert got.shape == want.shape == (len(CUTOFFS), 2 * half_size_max + 1)
    assert np.abs(got - want).max() <= KERNEL_ATOL
    assert (got[0] == 0).all()  # cutoff 0 -> the zero filter
    np.testing.assert_allclose(got[1:].sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 5, 16, 100])
def test_lowpass_kernels_exact_integer_half_size(k):
    """c = 8 / (2k): zeros / c / 2 is the integer k exactly (in float32 too
    for these k), so both libraries keep the same 2k+1 taps."""
    c = np.asarray([8.0 / (2 * k)], np.float32)
    got = tfilt.lowpass_kernels(torch.from_numpy(c), 128).numpy()
    want = np.asarray(jfilt.lowpass_kernels(jnp.asarray(c), 128))
    np.testing.assert_array_equal(got != 0, want != 0)
    assert np.abs(got - want).max() <= KERNEL_ATOL
    assert (got[0, : 128 - k] == 0).all() and (got[0, 128 + k + 1 :] == 0).all()


@pytest.mark.parametrize("half_size_max", [16, 1072])
@pytest.mark.parametrize("channels", [None, 2])
def test_lowpass_filter_both_routes_match_jax(half_size_max, channels):
    """33 taps take the direct grouped convolution, 2,145 taps the FFT route,
    in both packages."""
    taps = 2 * half_size_max + 1
    assert (taps <= tfilt.DIRECT_CONV_MAX_TAPS) == (half_size_max == 16)
    assert tfilt.DIRECT_CONV_MAX_TAPS == jfilt.DIRECT_CONV_MAX_TAPS
    x = music(batch=len(CUTOFFS), samples=9000, channels=channels)
    got = tfilt.lowpass_filter(torch.from_numpy(x), torch.from_numpy(CUTOFFS), half_size_max)
    want = jfilt.lowpass_filter(jnp.asarray(x), jnp.asarray(CUTOFFS), half_size_max)
    assert rel_err(got.numpy(), want) <= SIGNAL_RTOL


@pytest.mark.parametrize("name", ["highpass_filter", "bandpass_filter", "bandstop_filter"])
def test_high_and_band_filters_match_jax(name):
    x = music(batch=5, samples=9000, seed=7)
    lo = np.asarray([0.0, 0.01, 0.02, 0.05, 0.1], np.float32)
    hi = np.asarray([0.05, 0.07, 0.2, 0.3, 0.45], np.float32)
    args = (lo,) if name == "highpass_filter" else (lo, hi)
    got = getattr(tfilt, name)(torch.from_numpy(x), *map(torch.from_numpy, args), 512)
    want = getattr(jfilt, name)(jnp.asarray(x), *map(jnp.asarray, args), 512)
    assert rel_err(got.numpy(), want) <= SIGNAL_RTOL


@pytest.mark.parametrize("half_size_max", [16, 1072])
def test_highpass_cutoff_zero_returns_input_exactly(half_size_max):
    x = torch.from_numpy(music(batch=3, samples=9000))
    c = torch.tensor([0.0, 0.02, 0.0])
    y = tfilt.highpass_filter(x, c, half_size_max)
    assert torch.equal(y[0], x[0]) and torch.equal(y[2], x[2])
    assert not torch.equal(y[1], x[1])


def test_edge_pad_matches_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for arr in (x, x[:, 0]):
        got = tfilt._edge_pad(torch.from_numpy(arr), 3).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfilt._edge_pad(jnp.asarray(arr), 3)))


@pytest.mark.parametrize(
    "name",
    ["calculate_rms", "rms_normalize", "peak_normalize",
     "convert_decibels_to_amplitude_ratio", "convert_frequencies_to_mels",
     "convert_mels_to_frequencies"],
)
def test_utils_match_jax(name):
    rng = np.random.default_rng(5)
    x = np.abs(rng.standard_normal((3, 2, 500)).astype(np.float32)) * 40
    x[1] = 0.0  # an all-zero example
    got = getattr(tutils, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jutils, name)(jnp.asarray(x)))
    assert got.dtype == np.float32
    # 10 ** x and log10 round differently in XLA and in PyTorch, and
    # 10 ** x - 1 cancels
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_next_fast_len_and_object_dict():
    for n in (1, 7, 97, 4097, 81000):
        assert tutils.next_fast_len(n) == jutils.next_fast_len(n)
    d = tutils.ObjectDict(a=1)
    d.b = 2
    assert d.a == 1 and d["b"] == 2
    with pytest.raises(AttributeError):
        d.missing
    assert tutils.is_multichannel(torch.zeros(1, 2, 3))


@pytest.mark.parametrize("f_decay", [-2.0, 0.0, 2.0])
def test_colored_noise_statistics(f_decay):
    """Unit RMS and a spectral slope of the sign f_decay asks for (the
    white noise against JAX's: tests/test_torch_draws.py)."""
    key = prng.key(3)
    noise = tnoise.batch_colored_noise(key, torch.full((4,), f_decay), 20000, SR)
    assert noise.shape == (4, 20000) and noise.dtype == torch.float32
    # the second after the first repeats it
    assert torch.equal(noise[:, :SR], noise[:, SR : 2 * SR])
    np.testing.assert_allclose(tutils.calculate_rms(noise[:, :SR]).numpy(), 1.0, atol=1e-4)
    power = torch.fft.rfft(noise[:, :SR]).abs().square().mean(0)
    low, high = power[10:400].mean(), power[3600:3990].mean()
    if f_decay > 0:
        assert low > 4 * high
    elif f_decay < 0:
        assert high > 4 * low
    else:
        assert 0.7 < float(low / high) < 1.4
    again = tnoise.batch_colored_noise(prng.key(3), torch.full((4,), f_decay), 20000, SR)
    assert torch.equal(noise, again)
    # the batch's example 0 is one noise under the first key split from it
    one = tnoise.gen_colored_noise(prng.split(key, 4)[0], f_decay, 500, SR, device="cpu")
    assert one.shape == (500,) and torch.equal(one, noise[0, :500])


def test_direct_route_keeps_cudnn_on_with_tf32_off(monkeypatch):
    """The direct grouped convolution runs with cuDNN enabled and TF32 off,
    and the flags are as they were after it (``cudnn.flags(allow_tf32=...)``
    alone would switch cuDNN off)."""
    seen = []
    conv1d = tfilt.F.conv1d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32))
        return conv1d(*args, **kwargs)

    monkeypatch.setattr(tfilt.F, "conv1d", spy)
    before = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32)
    assert before == (True, True)  # PyTorch's defaults
    x = torch.from_numpy(music(2, 4000))
    tfilt.lowpass_filter(x, torch.tensor([0.1, 0.3]), half_size_max=16)
    assert seen == [(True, False)]
    assert (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32) == before

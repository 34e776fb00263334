"""Port parity: musicfpaugment_torch.augment transforms, banks and fused
stages against musicfpaugment_tpu.augment.

The JAX transform is called with a key; the port's ``apply`` gets the draws
that call makes, recomputed from the same key (tests/torch_port_helpers.py).
Tolerance: 1e-5 of the reference's largest magnitude (float32 through two
FFT/convolution libraries and differently rounded ``10 ** x``, ``sin``,
``cos``); clipping thresholds 1e-6; gated-off lanes bit-identical to the
input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.augment import transforms as TT
from musicfpaugment_torch.augment import compose as TC
from musicfpaugment_torch.core import prng
from musicfpaugment_tpu import augment as jaugment
from musicfpaugment_tpu.augment import transforms as JT
from torch_port_helpers import (
    SR,
    jax_noise_crop_draws,
    jax_stage_draws,
    music,
    port_banks,
    rel_err,
    to_torch,
)

RTOL = 1e-5
T = 12000


@pytest.fixture(scope="module")
def jbanks():
    return jaugment.synthetic_banks(
        sample_rate=SR, num_noise=8, num_irs=4, noise_row_length=2 * SR, seed=1)


@pytest.fixture(scope="module")
def tbanks(jbanks):
    return port_banks(*jbanks)


# name -> (class name, constructor arguments); the same for both packages
CASES = {
    "lowpass_direct_33_taps": ("LowPassFilter", dict(min_cutoff_freq=3000, max_cutoff_freq=3999, sample_rate=SR)),
    "highpass_fft_2145_taps": ("HighPassFilter", dict(min_cutoff_freq=30, max_cutoff_freq=150, sample_rate=SR)),
    "highpass_from_0hz_4097_taps": ("HighPassFilter", dict(min_cutoff_freq=0, max_cutoff_freq=150, sample_rate=SR)),
    "bandpass": ("BandPassFilter", dict(sample_rate=SR, half_size_max=256, max_center_frequency=2000)),
    "bandstop": ("BandStopFilter", dict(sample_rate=SR, half_size_max=256, max_center_frequency=2000)),
    "ir": ("ApplyImpulseResponse", dict(sample_rate=SR)),
    "ir_no_normalize": ("ApplyImpulseResponse", dict(sample_rate=SR, normalize=False)),
    "ir_delay_compensated": ("ApplyImpulseResponse", dict(sample_rate=SR, compensate_for_propagation_delay=True)),
    "noise": ("AddBackgroundNoise", dict(min_snr_in_db=-10, max_snr_in_db=10, sample_rate=SR)),
    "noise_no_normalize": ("AddBackgroundNoise", dict(min_snr_in_db=0, max_snr_in_db=0, sample_rate=SR, normalize=False)),
    "noise_mixup": ("AddBackgroundNoise", dict(min_snr_in_db=-5, max_snr_in_db=5, sample_rate=SR, mixup=True)),
    "colored_noise": ("AddColoredNoise", dict(sample_rate=SR)),
    "gain": ("Gain", dict(min_gain_in_db=-5, max_gain_in_db=5)),
    "clipping": ("Clipping", dict(max_percentile_threshold=0.1)),
    "clipping_batch_quantile": ("Clipping", dict(max_percentile_threshold=0.1, batch_quantile=True)),
    "peak_normalization": ("PeakNormalization", dict()),
}


def _pair(case, p):
    cls, kwargs = CASES[case]
    return getattr(JT, cls)(p=p, **kwargs), getattr(TT, cls)(p=p, **kwargs)


@pytest.mark.parametrize("channels", [None, 2])
@pytest.mark.parametrize("p", [0.5, 1.0])
@pytest.mark.parametrize("case", list(CASES))
def test_transform_apply_matches_jax(case, p, channels, jbanks, tbanks):
    jt, tt = _pair(case, p)
    x = music(batch=8, samples=T, seed=11, channels=channels)
    x[3] = 0.0  # an all-zero example
    key = jax.random.PRNGKey(7)
    want = np.asarray(jt(key, jnp.asarray(x), SR, noise_bank=jbanks[0], ir_bank=jbanks[1]))
    draws = jax_stage_draws(jt, key, 8, T, jbanks[0], jbanks[1])
    got = tt.apply(torch.from_numpy(x), draws, SR, noise_bank=tbanks[0], ir_bank=tbanks[1]).numpy()
    assert rel_err(got, want) <= RTOL
    off = ~draws["mask"].numpy()
    if p < 1.0:
        assert off.any() and (~off).any()
    np.testing.assert_array_equal(got[off], x[off])  # bit-identical lanes
    if case != "peak_normalization":
        assert (got[3] == 0).all() or case.startswith(("noise", "colored"))


@pytest.mark.parametrize("case", ["gain", "highpass_fft_2145_taps", "clipping", "ir"])
def test_p_zero_returns_input_before_any_draw(case, tbanks):
    _, tt = _pair(case, 0.0)
    x = torch.from_numpy(music(batch=2, samples=4000))
    # no key at all: a draw would fail on it
    y = tt(None, x, SR, noise_bank=tbanks[0], ir_bank=tbanks[1])
    assert y is x


@pytest.mark.parametrize("batch_quantile", [False, True])
def test_clipping_thresholds_match_jax(batch_quantile):
    jt = JT.Clipping(max_percentile_threshold=0.2, p=1.0, batch_quantile=batch_quantile)
    tt = TT.Clipping(max_percentile_threshold=0.2, p=1.0, batch_quantile=batch_quantile)
    x = music(batch=6, samples=T, seed=2)
    key = jax.random.PRNGKey(3)
    _, k_tfm = jax.random.split(key)
    lower_j, upper_j = jt._thresholds(k_tfm, jnp.asarray(x))
    draws = jax_stage_draws(jt, key, 6, T)
    lower, upper = tt.thresholds(draws, torch.from_numpy(x))
    np.testing.assert_allclose(lower.numpy(), np.asarray(lower_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(upper.numpy(), np.asarray(upper_j), atol=1e-6, rtol=0)
    y = tt.apply(torch.from_numpy(x), draws).numpy()
    clipped = (y != x).mean(axis=-1)
    if not batch_quantile:  # about q of each row is clipped
        q = draws["quantile"].numpy()
        np.testing.assert_allclose(clipped, q, atol=2e-3)


def test_peak_normalization_zero_row_and_peak():
    x = music(batch=3, samples=4000)
    x[1] = 0.0
    tt = TT.PeakNormalization(p=1)
    y = tt(prng.key(0), torch.from_numpy(x), SR)
    assert (y[1] == 0).all()
    np.testing.assert_allclose(y.abs().amax(-1).numpy()[[0, 2]], 1.0, atol=1e-6)


@pytest.mark.parametrize("num_samples", [T, 2 * SR, 3 * SR])
def test_noise_bank_crop_equals_jax_sample(num_samples, jbanks, tbanks):
    """Given JAX's scene/row/offset the port's crop is JAX's crop; a crop as
    long as the row (or longer) is the whole row."""
    key = jax.random.PRNGKey(5)
    want = np.asarray(jbanks[0].sample(key, 12, num_samples))
    d = to_torch(jax_noise_crop_draws(key, jbanks[0], 12, num_samples))
    got = tbanks[0].crop(d["scene"], d["row_u"], d["offset"], num_samples).numpy()
    # the gather is exact; the RMS normalization sums in another order
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    k1, k2 = jax.random.split(key)
    d2 = to_torch(jax_noise_crop_draws(k2, jbanks[0], 12, num_samples))
    d1 = to_torch(jax_noise_crop_draws(k1, jbanks[0], 12, num_samples))
    pair = tbanks[0].crop_pair(d1, d2, num_samples).numpy()
    np.testing.assert_allclose(
        pair, np.asarray(jbanks[0].sample_pair(key, 12, num_samples)), rtol=5e-6, atol=1e-6)


def test_bank_draws_in_range_and_sampling(jbanks, tbanks):
    nb, ib = tbanks
    key = prng.key(0)
    d = nb.draw(key, 4000, SR)
    assert d["scene"].min() == 0 and d["scene"].max() == nb.scene_starts.shape[0] - 1
    assert d["offset"].min() >= 0 and nb.row_length - SR - 100 < d["offset"].max() <= nb.row_length - SR
    # the draws are the JAX bank's under the same key, to the bit
    want = jax_noise_crop_draws(jax.random.PRNGKey(0), jbanks[0], 4000, SR)
    for k, v in to_torch(want).items():
        assert torch.equal(d[k], v), k
    assert nb.draw(key, 4000, 5 * SR)["offset"].max() == 0  # crops longer than the row
    idx = ib.draw(key, 4000)
    assert idx.min() == 0 and idx.max() == ib.num_irs - 1
    crops = nb.sample(key, 5, SR)
    assert crops.shape == (5, SR)
    np.testing.assert_allclose(crops.square().mean(-1).sqrt().numpy(), 1.0, atol=1e-5)
    assert nb.sample_pair(key, 5, SR).shape == (5, SR)
    assert ib.sample(key, 3).shape == (3, ib.irs.shape[1])
    assert nb.num_clips == 8 and nb.to("cpu").device.type == "cpu" and ib.to("cpu").num_irs == 4


# ------------------------------------------------------------ fused stages


def _fast_chains(jbanks, tbanks, **kw):
    from musicfpaugment_torch import augment as taugment

    jfp = jaugment.AugmentFP(jbanks[0], SR, impulse_response_dir=jbanks[1], **kw)
    tfp = taugment.AugmentFP(tbanks[0], SR, impulse_response_dir=tbanks[1], device="cpu", **kw)
    return jfp, tfp


def _fused_hpf_ir_case(jfp, tfp, x, seed):
    jt, tt = jfp._fast_pipeline.transforms, tfp._fast_pipeline.transforms
    keys = jax.random.split(jax.random.PRNGKey(seed), len(jt))
    B, n = x.shape
    want = np.asarray(JT.fused_highpass_ir(
        keys[0], keys[1], jnp.asarray(x), SR, jt[0], jt[1], jfp.ir_bank))
    d0 = jax_stage_draws(jt[0], keys[0], B, n)
    d1 = jax_stage_draws(jt[1], keys[1], B, n, ir_bank=jfp.ir_bank)
    xt = torch.from_numpy(x)
    fused = TT.fused_highpass_ir(xt, d0, d1, tt[0], tfp.ir_bank).numpy()
    unfused = tt[1].apply(tt[0].apply(xt, d0, SR), d1, SR, ir_bank=tfp.ir_bank).numpy()
    return fused, want, unfused, (d0, d1)


@pytest.mark.parametrize("seed", [0, 3])
def test_fused_highpass_ir_matches_jax_and_unfused(seed, jbanks, tbanks):
    jfp, tfp = _fast_chains(jbanks, tbanks)
    x = music(batch=16, samples=T)
    fused, want, unfused, (d0, d1) = _fused_hpf_ir_case(jfp, tfp, x, seed)
    assert rel_err(fused, want) <= RTOL
    # convolution associativity only (the JAX package's own test: 3e-6)
    scale = max(np.abs(unfused).max(), 1.0)
    assert np.abs(fused - unfused).max() / scale <= 5e-6
    # every gate combination, the masks set by hand: both off is the input
    tt = tfp._fast_pipeline.transforms
    d0["mask"] = torch.tensor([True, True, False, False] * 4)
    d1["mask"] = torch.tensor([True, False, True, False] * 4)
    xt = torch.from_numpy(x)
    fused = TT.fused_highpass_ir(xt, d0, d1, tt[0], tfp.ir_bank).numpy()
    unfused = tt[1].apply(tt[0].apply(xt, d0, SR), d1, SR, ir_bank=tfp.ir_bank).numpy()
    assert np.abs(fused - unfused).max() / max(np.abs(unfused).max(), 1.0) <= 5e-6
    np.testing.assert_array_equal(fused[3::4], x[3::4])
    np.testing.assert_array_equal(unfused[3::4], x[3::4])


def test_fused_highpass_ir_long_ir(jbanks, tbanks):
    """IRs longer than the HPF pad window (2*H1+1 taps) take the zero-fill
    branch of the left-edge correction."""
    rng = np.random.default_rng(2)
    L = 2 * 2048 + 2000  # > 2*H1 for the default HPF1 (H1 = 2048)
    irs = (rng.standard_normal((2, L)) * np.exp(-6.0 * np.arange(L) / L)).astype(np.float32)
    irs[:, 0] = 1.0
    from musicfpaugment_tpu.augment.banks import build_ir_bank

    jib = build_ir_bank(irs, SR)
    jfp, tfp = _fast_chains((jbanks[0], jib), port_banks(jbanks[0], jib))
    assert tfp._fast_pipeline.transforms[0].half_size_max == 2048
    fused, want, unfused, _ = _fused_hpf_ir_case(jfp, tfp, music(batch=8, samples=T), 3)
    assert rel_err(fused, want) <= RTOL
    scale = max(np.abs(unfused).max(), 1.0)
    assert np.abs(fused - unfused).max() / scale <= 5e-6


@pytest.mark.parametrize("seed,samples", [(0, T), (3, T), (11, T), (5, 16 + 1072)])
def test_fused_lowpass_highpass_matches_jax_and_unfused(seed, samples, jbanks, tbanks):
    """The interior from the fused kernel and the E = Hl + Hh edge regions
    stage by stage; inputs of T <= 2E run the stages."""
    jfp, tfp = _fast_chains(jbanks, tbanks)
    jl, jh = jfp._fast_pipeline.transforms[5:7]
    tl, th = tfp._fast_pipeline.transforms[5:7]
    assert (tl.half_size_max, th.half_size_max) == (jl.half_size_max, jh.half_size_max) == (16, 1072)
    x = music(batch=16, samples=samples)
    kl, kh = jax.random.split(jax.random.PRNGKey(seed))
    want = np.asarray(JT.fused_lowpass_highpass(kl, kh, jnp.asarray(x), SR, jl, jh))
    dl = jax_stage_draws(jl, kl, 16, samples)
    dh = jax_stage_draws(jh, kh, 16, samples)
    xt = torch.from_numpy(x)
    fused = TT.fused_lowpass_highpass(xt, dl, dh, tl, th).numpy()
    unfused = th.apply(tl.apply(xt, dl, SR), dh, SR).numpy()
    assert rel_err(fused, want) <= RTOL
    scale = max(np.abs(unfused).max(), 1.0)
    assert np.abs(fused - unfused).max() / scale <= 5e-6
    both_off = ~dl["mask"].numpy() & ~dh["mask"].numpy()
    np.testing.assert_array_equal(fused[both_off], x[both_off])


# ------------------------------------------------------------ composition


def _gains():
    return [TT.Gain(min_gain_in_db=g, max_gain_in_db=g + 0.01, p=1.0) for g in (1, 2, 4)]


def test_compose_draw_apply_equals_call():
    x = torch.from_numpy(music(batch=4, samples=2000))
    c = TC.Compose(_gains())
    assert len(c) == 3
    draws = c.draw(prng.key(5), 4, 2000)
    assert len(draws) == 3 and all(d["mask"].all() for d in draws)
    y = c.apply(x, draws)
    assert torch.equal(y, c(prng.key(5), x))
    db = 20 * torch.log10(y.abs().amax(-1) / x.abs().amax(-1))
    np.testing.assert_allclose(db.numpy(), 7.0, atol=0.05)
    rev = TC.Compose(c.transforms[::-1]).apply(x, draws[::-1])
    np.testing.assert_allclose(rev.numpy(), y.numpy(), rtol=1e-6)
    shuffled = TC.Compose(_gains(), shuffle=True)(prng.key(5), x)
    np.testing.assert_allclose(shuffled.abs().amax().item(), y.abs().amax().item(), rtol=1e-3)


def test_someof_oneof_pick_subsets():
    import random

    random.seed(0)
    x = torch.from_numpy(music(batch=2, samples=2000))
    keys = prng.split(prng.key(1), 31)
    seen = set()
    for k in keys[:20]:
        y = TC.OneOf(_gains())(k, x)
        seen.add(int(round(float(20 * torch.log10(y.abs().amax() / x.abs().amax())))))
    assert seen == {1, 2, 4}
    some = TC.SomeOf((2, None), _gains())
    for k in keys[20:30]:
        some(k, x)
        assert 2 <= len(some.transform_indexes) <= 3
    assert TC.SomeOf(1, _gains(), p=0.0)(keys[30], x) is x


def test_identity_keeps_the_other_stages_draws():
    """Replacing Gain by Identity leaves the draws of the stages after it
    unchanged: every stage takes its key of the chain's split."""
    stages = [TT.Gain(p=1.0), TT.Clipping(p=1.0)]
    a = TC.Compose(stages).draw(prng.key(9), 5, 100)
    b = TC.Compose([TT.Identity(), stages[1]]).draw(prng.key(9), 5, 100)
    assert torch.equal(a[1]["quantile"], b[1]["quantile"])
    assert set(b[0]) == {"mask"}


def test_cutoff_draws_stay_inside_the_mel_bounds():
    t = TT.HighPassFilter(min_cutoff_freq=30, max_cutoff_freq=150, p=0.5, sample_rate=SR)
    d = t.draw(prng.key(0), 5000, 100)
    lo, hi = t.cutoff_bounds_mel()
    hz = d["cutoff"].numpy() * SR
    mel = 2595.0 * np.log10(1.0 + hz / 700.0)
    assert lo - 1e-2 <= mel.min() and mel.max() <= hi + 1e-2
    assert mel.min() < lo + 2 and mel.max() > hi - 2  # and they fill them
    assert 0.45 < d["mask"].float().mean() < 0.55
    # the bounds are those of the JAX transform's _sample_cutoffs
    assert lo == np.ceil(JT._hz_to_mel(30.0)) and hi == np.floor(JT._hz_to_mel(150.0))


def test_constructor_checks():
    with pytest.raises(ValueError):
        TT.LowPassFilter(min_cutoff_freq=10, max_cutoff_freq=5)
    with pytest.raises(ValueError):
        TT.Gain(min_gain_in_db=1, max_gain_in_db=1)
    with pytest.raises(ValueError):
        TT.BandPassFilter(max_bandwidth_fraction=2.0)
    with pytest.raises(ValueError):
        TT.AddBackgroundNoise(min_snr_in_db=3, max_snr_in_db=1)
    with pytest.raises(ValueError):
        TT.ApplyImpulseResponse(p=1.0)(prng.key(0), torch.zeros(1, 10), SR)
    with pytest.raises(RuntimeError):
        TT.Gain(p=1.0)(prng.key(0), torch.zeros(10))

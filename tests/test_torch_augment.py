"""Port parity: musicfpaugment_torch.augment.AugmentFP, the banks and the
bank converters against musicfpaugment_tpu.augment.

The whole chain: the JAX side is ``AugmentFP.batch_augment(x, key=key)``;
the port's ``apply`` gets the draws that call makes, recomputed from the same
key (tests/torch_port_helpers.py). Outputs have peak 1, and the largest
difference allowed is CHAIN_ATOL: float32 through two FFT and convolution
libraries, ``10 ** x``/``sin``/``cos`` rounded differently, and a clipping
threshold that moves with them.

The port's own keys are held against JAX's draws and outputs in
tests/test_torch_draws.py; here the chain's properties under the port's
keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch import augment as taugment
from musicfpaugment_torch import convert
from musicfpaugment_torch.core import noise as tnoise
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.testing import parameters as tparams
from musicfpaugment_tpu import augment as jaugment
from musicfpaugment_tpu.testing import parameters as jparams
from torch_port_helpers import SR, jax_chain_draws, music, port_banks

CHAIN_ATOL = 5e-6  # on outputs whose peak is 1; these cases reach 7.2e-7 at worst
T = 12000

PARAMETER_SETS = {
    "DEFAULT_PARAMETERS": jaugment.DEFAULT_PARAMETERS,
    "bn_0": jparams.test_pipelines_parameters["bn_0"],
    "reverb": jparams.test_pipelines_parameters["reverb"],
    "recording_device": jparams.test_pipelines_parameters["recording_device"],
}
MODES = {
    "fast_fused": {},
    "fast_unfused": {"fuse_lti": False},
    "exact": {"fast_chain": False},
    "exact_batch_quantile": {"batch_quantile_clipping": True},
}


@pytest.fixture(scope="module")
def jbanks():
    return jaugment.synthetic_banks(
        sample_rate=SR, num_noise=8, num_irs=4, noise_row_length=2 * SR, seed=1)


@pytest.fixture(scope="module")
def tbanks(jbanks):
    return port_banks(*jbanks)


def _augmenter(tbanks, **kw):
    return taugment.AugmentFP(tbanks[0], SR, impulse_response_dir=tbanks[1], device="cpu", **kw)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("params", list(PARAMETER_SETS))
def test_chain_matches_jax_on_jax_draws(params, mode, jbanks, tbanks):
    parameters = PARAMETER_SETS[params]
    jfp = jaugment.AugmentFP(
        jbanks[0], SR, parameters=parameters, impulse_response_dir=jbanks[1], **MODES[mode])
    tfp = _augmenter(tbanks, parameters=parameters, **MODES[mode])
    assert (tfp.fast_chain, tfp.fuse_lti) == (jfp.fast_chain, jfp.fuse_lti)
    x = music(batch=8, samples=T, seed=21, channels=1)
    x[5] = 0.0
    key = jax.random.PRNGKey(13)
    want = np.asarray(jfp.batch_augment(jnp.asarray(x), key=key))
    draws = jax_chain_draws(jfp, key, 8, T)
    got = tfp.apply(x, draws).numpy()
    assert got.shape == want.shape == (8, 1, T)
    err = float(np.abs(got - want).max())
    assert err <= CHAIN_ATOL, err
    np.testing.assert_allclose(np.abs(got).max(-1)[:5], 1.0, atol=1e-6)
    if params != "bn_0" and params != "DEFAULT_PARAMETERS":
        assert (got[5] == 0).all()  # nothing but noise moves a zero input


def test_multichannel_chain_matches_jax(jbanks, tbanks):
    """More than one channel takes the stage-by-stage chain in both."""
    jfp = jaugment.AugmentFP(jbanks[0], SR, impulse_response_dir=jbanks[1])
    tfp = _augmenter(tbanks)
    x = music(batch=4, samples=T, seed=8, channels=2)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jfp.batch_augment(jnp.asarray(x), key=key))
    got = tfp.apply(x, jax_chain_draws(jfp, key, 4, T)).numpy()
    assert float(np.abs(got - want).max()) <= CHAIN_ATOL


# ------------------------------------------------------------ banks


def _assert_banks_equal(tb, jb):
    (tn, ti), (jn, ji) = tb, jb
    np.testing.assert_array_equal(tn.clips.numpy(), np.asarray(jn.clips))
    np.testing.assert_array_equal(tn.scene_starts.numpy(), np.asarray(jn.scene_starts))
    np.testing.assert_array_equal(tn.scene_counts.numpy(), np.asarray(jn.scene_counts))
    np.testing.assert_array_equal(ti.irs.numpy(), np.asarray(ji.irs))
    np.testing.assert_array_equal(ti.lengths.numpy(), np.asarray(ji.lengths))
    assert tn.sample_rate == jn.sample_rate and ti.sample_rate == ji.sample_rate
    assert tn.clips.dtype == torch.float32 and tn.scene_starts.dtype == torch.int32


def test_synthetic_banks_equal_jax():
    kw = dict(sample_rate=SR, num_noise=8, num_irs=4, noise_row_length=2 * SR, seed=5)
    _assert_banks_equal(taugment.synthetic_banks(device="cpu", **kw), jaugment.synthetic_banks(**kw))


def test_dcase_shaped_banks_equal_jax():
    kw = dict(sample_rate=SR, noise_row_length=2 * SR, hours=0.05, num_scenes=5, num_irs=17, seed=3)
    tb = taugment.dcase_shaped_banks(device="cpu", **kw)
    _assert_banks_equal(tb, jaugment.dcase_shaped_banks(**kw))
    assert tb[0].scene_starts.shape[0] == 5 and tb[1].num_irs == 17
    assert int(tb[0].scene_counts.sum()) == max(5, int(0.05 * 3600 * SR / (2 * SR)))


def test_build_banks_from_wav_paths_equal_jax(tmp_path):
    import scipy.io.wavfile

    from musicfpaugment_tpu.augment import banks as jb

    rng = np.random.default_rng(0)
    scenes = {}
    for scene in ("park", "bus"):
        (tmp_path / scene).mkdir()
        scenes[scene] = []
        for i, sr in enumerate((8000, 16000)):
            path = tmp_path / scene / f"{i}.wav"
            data = (rng.standard_normal((sr // 2 * (i + 1), 2)) * 8000).astype(np.int16)
            scipy.io.wavfile.write(path, sr, data)
            scenes[scene].append(str(path))
    tn = taugment.build_noise_bank(scenes, SR, row_length=6000, seed=2, device="cpu")
    jn = jb.build_noise_bank(scenes, SR, row_length=6000, seed=2)
    ti = taugment.build_ir_bank(str(tmp_path / "park"), SR, device="cpu")
    ji = jb.build_ir_bank(str(tmp_path / "park"), SR)
    # the JAX package may decode through its native reader: same samples
    _assert_banks_equal((tn, ti), (jn, ji))
    flat = taugment.build_noise_bank(scenes["bus"], SR, row_length=3000, device="cpu")
    assert flat.clips.shape == (2, 3000) and flat.scene_counts.tolist() == [2]
    with pytest.raises(ValueError):
        taugment.build_ir_bank(str(tmp_path / "nothing_here"), SR, device="cpu")


def test_convert_banks_round_trip(jbanks):
    tn, ti = port_banks(*jbanks)
    _assert_banks_equal((tn, ti), jbanks)
    with pytest.raises(ValueError):
        convert.noise_bank_from_arrays(
            np.zeros((4, 10)), np.asarray([0, 2]), np.asarray([2, 1]), SR, device="cpu")
    with pytest.raises(ValueError):
        convert.ir_bank_from_arrays(np.zeros((4, 10)), np.zeros(3), SR, device="cpu")
    with pytest.raises(RuntimeError):  # the card is the default
        convert.ir_bank_from_arrays(np.zeros((4, 10)), np.zeros(4), SR)


def test_condition_parameters_equal_jax():
    assert tparams.test_pipelines_parameters == jparams.test_pipelines_parameters
    assert list(tparams.test_pipelines_parameters) == list(jparams.test_pipelines_parameters)
    assert list(tparams.queries_paths) == list(jparams.queries_paths)
    assert tparams.afp_settings["audfprint"] == jparams.afp_settings["audfprint"]
    assert taugment.DEFAULT_PARAMETERS == jaugment.DEFAULT_PARAMETERS
    assert taugment.WAVEFORM_SAMPLING_RATE == jaugment.WAVEFORM_SAMPLING_RATE
    assert taugment.IMPULSE_RESPONSE_DIR == jaugment.IMPULSE_RESPONSE_DIR
    assert set(taugment.__all__) == set(jaugment.__all__)


# ------------------------------------------------------------ own keys


def test_freeze_determinism_and_streams(tbanks):
    fp = _augmenter(tbanks)
    x = music(batch=4, samples=T, channels=1)
    fp.freeze_parameters(42)
    a, a2 = fp.batch_augment(x), fp.batch_augment(x)
    fp.freeze_parameters(42)
    b = fp.batch_augment(x)
    assert torch.equal(a, b) and not torch.equal(a, a2)  # the stream advances
    c = fp.batch_augment(x, key=prng.key(7))
    assert torch.equal(c, fp.batch_augment(x, key=prng.key(7)))
    fp.unfreeze_parameters()
    assert not fp.are_parameters_frozen
    one = fp(x[0, 0])
    assert one.shape == (T,) and fp(x[0]).shape == (1, T)


@pytest.mark.parametrize("mode", list(MODES))
def test_batch_augment_indexed_ignores_batch_size(mode, tbanks):
    """The frozen-seed query set is a function of (seed, index) only. One
    CPU thread: the FFT library rounds a transform differently when it
    splits a small batch over threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        fp = _augmenter(tbanks, **MODES[mode])
        fp.freeze_parameters(42)
        x = torch.from_numpy(music(batch=64, samples=8000, channels=1))
        whole = fp.batch_augment_indexed(x, range(64))
        parts = torch.cat([
            fp.batch_augment_indexed(x[i : i + 8], range(i, i + 8)) for i in range(0, 64, 8)])
        assert torch.equal(whole, parts)
        again = fp.batch_augment_indexed(x[10:12], np.asarray([10, 11]))
        assert torch.equal(again, whole[10:12])
        other = fp.batch_augment_indexed(x[10:12], [11, 10])
        assert not torch.equal(other, whole[10:12])
        assert not torch.equal(fp.batch_augment_indexed(x[:2], [0, 1], base_key=prng.key(43)), whole[:2])
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", ["fast_fused", "exact"])
def test_zero_input_stays_zero_and_peak_is_one(mode, tbanks):
    params = tparams.test_pipelines_parameters["default_parameters"]
    fp = _augmenter(tbanks, parameters=params, **MODES[mode])
    x = music(batch=16, samples=T, channels=1)
    x[3] = 0.0
    y = fp.batch_augment(x, key=prng.key(0))
    assert torch.isfinite(y).all()
    assert (y[3] == 0).all()
    peaks = y.abs().amax(-1).flatten()
    np.testing.assert_allclose(np.delete(peaks.numpy(), 3), 1.0, atol=1e-6)


def test_achieved_snr_matches_the_drawn_one(tbanks):
    """Noise alone, exact chain: 20 log10(rms(signal) / rms(added noise)) is
    the drawn SNR (the final normalization scales both alike)."""
    params = dict(tparams.test_pipelines_parameters["bn_0"], min_snr_in_db=-10, max_snr_in_db=10)
    fp = _augmenter(tbanks, parameters=params, fast_chain=False)
    x = torch.from_numpy(music(batch=32, samples=T))
    draws = fp.draw(32, T, prng.key(4))
    y = fp.apply(x, draws)
    noise = y / y.abs().amax(-1, keepdim=True)  # y itself has peak 1
    bank_noise = fp.noise_bank.crop(draws[2]["scene"], draws[2]["row_u"], draws[2]["offset"], T)
    # least squares of y on (x, bank_noise) recovers the two gains
    A = torch.stack([x, bank_noise], dim=-1)
    sol = torch.linalg.lstsq(A, noise.unsqueeze(-1)).solution[:, :, 0]
    rms = lambda v: v.square().mean(-1).sqrt()
    achieved = 20 * torch.log10(sol[:, 0] * rms(x) / (sol[:, 1] * rms(bank_noise)))
    np.testing.assert_allclose(achieved.numpy(), draws[2]["snr_db"].numpy(), atol=0.2)
    assert draws[2]["snr_db"].min() < -5 and draws[2]["snr_db"].max() > 5


def test_clip_fraction_of_the_recording_device_chain(tbanks):
    params = dict(tparams.test_pipelines_parameters["recording_device"],
                  proba_cutoff_freq2=0, proba_cutoff_freq3=0, max_percentile_threshold=0.2)
    fp = _augmenter(tbanks, parameters=params, fast_chain=False)
    x = torch.from_numpy(music(batch=16, samples=T))
    draws = fp.draw(16, T, prng.key(1))
    y = fp.apply(x, draws)
    # clipped samples sit on the row's largest or smallest value
    flat_top = ((y == y.amax(-1, keepdim=True)) | (y == y.amin(-1, keepdim=True))).float().mean(-1)
    np.testing.assert_allclose(flat_top.numpy(), draws[4]["quantile"].numpy(), atol=3e-3)


def test_chain_draws_layout(tbanks):
    fast, exact = _augmenter(tbanks), _augmenter(tbanks, fast_chain=False)
    a = fast.draw(6, T, prng.key(3))
    b = exact.draw(6, T, prng.key(3))
    assert len(a) == len(b) == 8
    assert set(a[3]) == {"mask"} and set(b[3]) == {"mask", "gain_db"}
    for i in (0, 1, 2, 4, 5, 6, 7):
        assert a[i].keys() == b[i].keys()
        for k in a[i]:
            assert torch.equal(a[i][k], b[i][k])
            assert a[i][k].device.type == "cpu" and a[i][k].shape == (6,)
    off = _augmenter(tbanks, batch_quantile_clipping=True)
    assert not off.fast_chain and not off.fuse_lti


def test_default_device_is_the_card(tbanks):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taugment.AugmentFP(tbanks[0], SR, impulse_response_dir=tbanks[1])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taugment.synthetic_banks()
    clips = np.ones((2, 100), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taugment.build_noise_bank(clips, SR, row_length=100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taugment.build_ir_bank(clips, SR)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnoise.gen_colored_noise(prng.key(0), 1.0, 100, SR)

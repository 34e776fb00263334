"""The denoiser hooks of the frontend, the peaks, the analyzer and the
matcher, port against JAX with the same UNet weights (CPU, base=8).

Tolerances: the frontend with the hook 1e-5 of its largest value; peak masks
with the hook equal JAX's in >= 0.999 of cells (the two FFT libraries round
differently, which moves marginal peaks); an identity callable is bit-equal
to no hook.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch import convert
from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.afp.audfprint import peaks as tp
from musicfpaugment_torch.afp.audfprint.analyzer import pad_waveform_batch
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.models import UNet
from musicfpaugment_torch.testing.parameters import afp_settings
from musicfpaugment_tpu.afp.audfprint import AudfprintPeaks as JAudfprintPeaks
from musicfpaugment_tpu.afp.audfprint import DeviceMatcher as JDeviceMatcher
from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
from musicfpaugment_tpu.afp.audfprint import peaks as jp
from musicfpaugment_tpu.models import UNet as JUNet

from torch_port_helpers import few_threads, flax_unet_variables, make_identity_unet, port_unet, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
N_HOP = 256


@pytest.fixture(scope="module")
def hooks():
    """One UNet's weights as the JAX hook and as the port's."""
    jm = JUNet(1, 1, base=8)
    params, stats = flax_unet_variables(jm, (1, 16, 16), seed=12)
    variables = {"params": params, "batch_stats": stats}
    j_hook = lambda s: jm.apply(variables, s, train=False).astype(jnp.float32)
    return j_hook, convert.unet_denoiser(port_unet(params, stats))


def _waves(batch=3, seconds=3.0, seed=21):
    return next(synthetic_clean_batches(batch, int(seconds * SR), seed=seed, sample_rate=SR))


def test_frontend_with_the_hook_matches_jax(hooks):
    j_hook, t_hook = hooks
    x = _waves()
    got = tp.spectrogram_frontend(torch.from_numpy(x), denoiser=t_hook)
    want = np.asarray(jp.spectrogram_frontend(jnp.asarray(x), denoiser=j_hook))
    assert got.dtype == torch.float32 and got.shape == (3, 257, 94)
    assert rel_err(got.numpy(), want) <= 1e-5
    plain = tp.spectrogram_frontend(torch.from_numpy(x))
    assert float((got - plain).abs().max()) > 1e-2  # the hook did something


def test_masks_with_the_hook_match_jax(hooks):
    j_hook, t_hook = hooks
    x = _waves(seed=22)
    got = tp.find_peaks_batch(torch.from_numpy(x), denoiser=t_hook).numpy()
    want = np.asarray(jp.find_peaks_batch(jnp.asarray(x), denoiser=j_hook))
    assert got.shape == want.shape == (3, 256, 94)
    assert (got == want).mean() >= 0.999
    assert got.sum() > 30 and abs(int(got.sum()) - int(want.sum())) <= 0.1 * want.sum()
    assert (got != tp.find_peaks_batch(torch.from_numpy(x)).numpy()).any()


def test_an_identity_callable_is_bit_equal_to_no_hook():
    x = torch.from_numpy(_waves(seed=23))
    calls = []

    def identity(sgram):
        calls.append(tuple(sgram.shape))
        return sgram

    assert torch.equal(tp.spectrogram_frontend(x, denoiser=identity), tp.spectrogram_frontend(x))
    assert torch.equal(tp.prune_input(x, denoiser=identity), tp.prune_input(x))
    assert torch.equal(tp.find_peaks_batch(x, denoiser=identity), tp.find_peaks_batch(x))
    assert calls == [(3, 257, 94)] * 3
    # the UNet with identity weights gives the same masks in >= 0.999 of cells
    ident = convert.unet_denoiser(make_identity_unet(UNet(1, 1, base=8)))
    same = tp.find_peaks_batch(x, denoiser=ident) == tp.find_peaks_batch(x)
    assert float(same.float().mean()) >= 0.999


def test_mixed_lengths_zero_the_padded_columns_again_after_the_hook(hooks):
    j_hook, t_hook = hooks
    tracks = _waves(seed=24)
    lens = [3 * SR, 2 * SR + 77, SR + 4001]
    batch, valid = pad_waveform_batch([t[:n] for t, n in zip(tracks, lens)])
    vf = 1 + valid // N_HOP
    offset = lambda s: s + 0.25  # a denoiser that leaves nothing at zero
    sg = tp.spectrogram_frontend(batch, denoiser=offset, valid_frames=torch.from_numpy(vf))
    for b, n in enumerate(vf):
        assert float(sg[b, :, n:].abs().max()) == 0.0 and float(sg[b, :, :n].min()) >= 0.25
    got = tp.find_peaks_batch(batch, valid_frames=torch.from_numpy(vf), denoiser=t_hook)
    for b, n in enumerate(vf):
        assert not got[b, :, n:].any() and got[b, :, :n].any()
    want = np.asarray(jp.find_peaks_batch(
        jnp.asarray(batch.numpy()), denoiser=j_hook, valid_frames=jnp.asarray(vf)))
    assert (got.numpy() == want).mean() >= 0.999


@pytest.mark.parametrize("with_valid", [False, True])
def test_stacked_shifts_with_the_hook_equal_per_shift_calls(hooks, with_valid):
    _, t_hook = hooks
    tracks = _waves(seed=25)[:, : 93 * N_HOP]
    seen = []

    def hook(sgram):
        seen.append(tuple(sgram.shape))
        return t_hook(sgram)

    if with_valid:
        batch, valid = pad_waveform_batch(
            [t[:n] for t, n in zip(tracks, [93 * N_HOP, 2 * SR + 77, SR + 4001])])
        vs = torch.from_numpy(valid)
    else:
        batch, vs = torch.from_numpy(tracks), None
    got = tp.find_peaks_shifts(batch, 4, valid_samples=vs, denoiser=hook)
    frames = 1 + batch.shape[-1] // N_HOP
    # the hook sees each shift's own spectrogram, one column fewer past shift 0
    assert seen == [(3, 257, frames)] + [(3, 257, frames - 1)] * 3
    for s, g in enumerate(got):
        off = int(s / 4 * N_HOP)
        vf = None if vs is None else 1 + (vs - off) // N_HOP
        want = tp.find_peaks_batch(batch[:, off:], valid_frames=vf, denoiser=t_hook)
        assert g.shape == want.shape and torch.equal(g, want) and g.any()


def test_match_waveforms_with_the_hook_gives_jax_verdicts(hooks):
    # an untrained UNet's output carries no music: let it move every bin by
    # up to 20%, so that the denoised queries still match
    j_hook = lambda s: s * (1.0 + 0.2 * jnp.tanh(hooks[0](s)))
    t_hook = lambda s: s * (1.0 + 0.2 * torch.tanh(hooks[1](s)))
    tracks = next(synthetic_clean_batches(6, 10 * SR, seed=26, sample_rate=SR))
    names = [f"trk{i}" for i in range(6)]
    t_an = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    j_an = JAudfprintPeaks(afp_settings["audfprint"])
    t_ht, j_ht = HashTable(depth=20), JHashTable(depth=20)
    t_an.ingest_batch(t_ht, names, tracks)
    j_an.ingest_batch(j_ht, names, tracks)
    crops = np.stack([t[2 * SR + 50 * i :][: 3 * SR] for i, t in enumerate(tracks)])
    got = DeviceMatcher(t_ht, device="cpu").match_waveforms(crops, shifts=4, denoiser=t_hook)
    want = JDeviceMatcher(j_ht).match_waveforms(crops, shifts=4, denoiser=j_hook)
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert sum(g[0] == "MATCH" and g[1] == n for g, n in zip(got, names)) >= 5
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= max(2, 0.05 * w[2]), (g, w)
    plain = DeviceMatcher(t_ht, device="cpu").match_waveforms(crops, shifts=4)
    assert [p[2] for p in plain] != [g[2] for g in got]


def test_analyzer_constructor_checks_and_hooks(hooks):
    _, t_hook = hooks
    params = afp_settings["audfprint"]
    plain = AudfprintPeaks(params, device="cpu")
    assert plain._spec_hook() is None and not plain.denoising
    with pytest.raises(ValueError, match="'demucs' or 'unet'"):
        AudfprintPeaks(params, denoising=True, denoising_model="wavenet", device="cpu")
    with pytest.raises(ValueError, match="requires spec_denoiser"):
        AudfprintPeaks(params, denoising=True, denoising_model="unet", device="cpu")
    with pytest.raises(ValueError, match="requires wave_denoiser"):
        AudfprintPeaks(params, denoising=True, denoising_model="demucs", spec_denoiser=t_hook, device="cpu")
    # a hook without ``denoising`` is carried and not used
    idle = AudfprintPeaks(params, denoising_model="unet", spec_denoiser=t_hook, device="cpu")
    assert idle._spec_hook() is None
    unet = AudfprintPeaks(params, denoising=True, denoising_model="unet", spec_denoiser=t_hook, device="cpu")
    assert unet._spec_hook() is t_hook
    x = _waves(seed=27)
    assert torch.equal(idle.peaks_batch(x), plain.peaks_batch(x))
    assert torch.equal(unet.peaks_batch(x), tp.find_peaks_batch(torch.from_numpy(x), denoiser=t_hook))
    for a, b in zip(unet.hashes_batch(x, shifts=2), plain.hashes_batch(x, shifts=2)):
        assert len(a) > 0 and not np.array_equal(a, b)
    # a waveform denoiser runs once, before the peaks, and no spectrogram hook
    seen = []

    def flip(w):
        seen.append(tuple(w.shape))
        return torch.flip(w, dims=[-1])

    wave = AudfprintPeaks(params, denoising=True, denoising_model="demucs", wave_denoiser=flip,
                          spec_denoiser=t_hook, device="cpu")
    assert wave._spec_hook() is None
    flipped = np.ascontiguousarray(x[:, ::-1])
    assert torch.equal(wave.peaks_batch(x), plain.peaks_batch(flipped))
    for a, b in zip(wave.hashes_batch(x, shifts=4), plain.hashes_batch(flipped, shifts=4)):
        np.testing.assert_array_equal(a, b)
    mask, d, _ = wave.wavfile2peaks(x[0], get_masks_waveforms=True)
    np.testing.assert_array_equal(d, flipped[0])
    np.testing.assert_array_equal(mask, plain.find_peaks(flipped[0])[1])
    np.testing.assert_array_equal(wave.wavfile2hashes(x[0]), plain.hashes_batch(flipped[:1])[0])
    assert seen == [(3, 24000), (3, 24000), (1, 24000), (1, 24000)]

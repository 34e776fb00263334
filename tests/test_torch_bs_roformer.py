"""The port's Band-Split RoPE Transformer against the plain reference
(``portbench/ref/models/bs_roformer.py``, the benchmark's frozen reference,
loaded by path: the published forward written in plain PyTorch, attention
as softmax(Q K^T / sqrt(d)) V, RoPE as pair rotations, the iSTFT written
out), on seeded random weights at small widths (15 bands of the published
layout's shape over a 512-point STFT, width 32, two axial blocks of two
heads), on the CPU. The JAX package has no BS-RoFormer.

Tolerances, of the output's peak: 1e-10 in float64 (the two forwards differ
only in the order of their sums: the fused attention against the
written-out softmax, ``torch.istft`` against the written-out overlap-add;
2e-15 read); 2e-5 in float32 (float32's 6e-8 over sums of up to 512 terms
through four attention and four feed-forward layers, the band split, the
mask MLPs and a division by the window's envelope in the iSTFT; 1e-6 read).
Each planted fault has to move the output by at least ten times the
float32 tolerance. Also: the published configuration on the meta device,
RoPE and RMSNorm against their closed forms, the band layout, an identity
mask through the STFT and iSTFT, the keywords left out, the audfprint and
Dejavu waveform hooks, the spans and the token counter, and TF32 held off.
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch
from torch import nn

from musicfpaugment_torch import convert
from musicfpaugment_torch.afp.audfprint import AudfprintPeaks
from musicfpaugment_torch.afp.dejavu import Dejavu, read
from musicfpaugment_torch.models import BSRoformer
from musicfpaugment_torch.models import bs_roformer as R
from musicfpaugment_torch.testing import dejavu_exps
from musicfpaugment_torch.testing.parameters import afp_settings
from musicfpaugment_torch.utils import profiling

from torch_threads import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference():
    path = os.path.join(REPO, "portbench", "ref", "models", "bs_roformer.py")
    spec = importlib.util.spec_from_file_location("plain_bs_roformer", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


P = _load_reference()

F64_TOL = 1e-10
F32_TOL = 2e-5
FAULT_MOVE = 10 * F32_TOL
SR = 8000
BANDS = [4] * 6 + [8] * 3 + [16] * 2 + [32] * 2 + [56, 57]
TINY = dict(dim=32, depth=2, heads=2, dim_head=16, time_transformer_depth=1,
            freq_transformer_depth=1, freqs_per_bands=BANDS, stft_n_fft=512,
            stft_hop_length=110, stft_win_length=512)
PUBLISHED = dict(dim=384, depth=12, time_transformer_depth=1, freq_transformer_depth=1,
                 stft_hop_length=441)
# the published configuration at one channel and one stem
PUBLISHED_PARAMETERS = 91_029_894
# an 8 s query at the published STFT: 146 frames x 62 bands
PUBLISHED_TOKENS = (146, 62)


def _weights(model: nn.Module, seed: int) -> dict:
    """Seeded weights: matrices at their fan-in's scale, RMSNorm scales near
    1, biases at 0.1."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        z = torch.randn(v.shape, generator=gen)
        if k.endswith("gamma"):
            out[k] = 1.0 + 0.1 * z
        elif v.dim() == 2:
            out[k] = z * math.sqrt(2.0 / v.shape[1])
        else:
            out[k] = 0.1 * z
    return out


def _pair(seed: int = 5, **kw):
    """(program, reference) in evaluation on the same weights."""
    args = dict(TINY, **kw)
    prog, ref = BSRoformer(**args).eval(), P.BSRoformer(**args).eval()
    w = _weights(ref, seed)
    prog.load_state_dict(w)
    ref.load_state_dict(w)
    return prog, ref


def _waves(shape, seed: int = 0) -> torch.Tensor:
    """Tones and noise, peak ~1."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(shape[-1]) / SR
    tones = sum(torch.sin(2 * math.pi * f * t) for f in (220.0, 660.0, 1530.0))
    return 0.3 * tones + 0.3 * torch.randn(shape, generator=gen)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("shape", [(2, 4000), (2, 1, 4000), (3, 2600), (2, 4321)],
                         ids=["two_d", "channel_axis", "short", "off_hop"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, F64_TOL), (torch.float32, F32_TOL)],
                         ids=["float64", "float32"])
def test_program_matches_plain_reference(shape, dtype, tol):
    prog, ref = _pair()
    prog.to(dtype)
    ref.to(dtype)
    x = _waves(shape, seed=len(shape) + shape[-1]).to(dtype)
    with torch.no_grad():
        got, want = prog(x), ref(x.reshape(shape[0], shape[-1]))
    assert got.shape == shape and got.dtype == dtype
    assert _rel(got.reshape(want.shape), want) <= tol


def test_published_configuration_on_the_meta_device():
    """The published widths: 91.0M parameters at one channel, the same
    names and shapes as the reference's, and 146 frames x 62 bands of width
    384 for an 8 s, 8 kHz query, (B x 62, 146) sequences along time and
    (B x 146, 62) across the bands."""
    with torch.device("meta"):
        prog, ref = BSRoformer(**PUBLISHED), P.BSRoformer(**PUBLISHED)
    assert {k: v.shape for k, v in prog.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    assert sum(p.numel() for p in prog.parameters()) == PUBLISHED_PARAMETERS
    assert sum(p.numel() for p in ref.parameters()) == PUBLISHED_PARAMETERS
    assert "layers.11.1.layers.0.0.to_qkv.weight" in prog.state_dict()
    assert "mask_estimators.0.to_freqs.61.0.2.weight" in prog.state_dict()
    assert not any("rotary" in k for k in prog.state_dict())
    seen = {}

    class Seen(Exception):
        pass

    def time_axis(mod, args):
        seen["time"] = tuple(args[0].shape)

    def band_axis(mod, args):
        seen["band"] = tuple(args[0].shape)
        raise Seen

    prog.layers[0][0].register_forward_pre_hook(time_axis)
    prog.layers[0][1].register_forward_pre_hook(band_axis)
    with pytest.raises(Seen):
        prog(torch.empty(2, 8 * SR, device="meta"))
    T, K = PUBLISHED_TOKENS
    assert seen == {"time": (2 * K, T, 384), "band": (2 * T, K, 384)}
    assert ref.eval()(torch.empty(2, 8 * SR, device="meta")).shape == (2, 8 * SR)


def test_published_band_layout():
    for layout in (R.DEFAULT_FREQS_PER_BANDS, P.DEFAULT_FREQS_PER_BANDS):
        assert len(layout) == 62 and sum(layout) == 1025
        assert layout == (2,) * 24 + (4,) * 12 + (12,) * 8 + (24,) * 8 + (48,) * 8 + (128, 129)
    with pytest.raises(ValueError, match="cover"):
        BSRoformer(**dict(TINY, freqs_per_bands=BANDS[:-1]))


def _closed_form_rope(x: np.ndarray, pairing: str) -> np.ndarray:
    """(n, d) rotated in float64: pair i is channels (2 i, 2 i + 1)
    (interleaved) or (i, i + d / 2) (split halves), turned by
    pos * 10000^(-2 i / d)."""
    n, d = x.shape
    out = np.empty_like(x)
    for p in range(n):
        for i in range(d // 2):
            a, b = (2 * i, 2 * i + 1) if pairing == "interleaved" else (i, i + d // 2)
            angle = p * 10000.0 ** (-2.0 * i / d)
            c, s = math.cos(angle), math.sin(angle)
            out[p, a] = x[p, a] * c - x[p, b] * s
            out[p, b] = x[p, b] * c + x[p, a] * s
    return out


@pytest.mark.parametrize("side", ["program", "reference"])
@pytest.mark.parametrize("axis,n", [("time", 146), ("band", 62)])
def test_rope_against_its_closed_form(side, axis, n):
    """Positions 0 .. n - 1 of each axis, turned pair by pair; a
    split-half pairing is not what either computes."""
    x = torch.randn(n, 64, generator=torch.Generator().manual_seed(n), dtype=torch.float64)
    if side == "program":
        with torch.device("meta"):
            model = BSRoformer(**PUBLISHED)
        rope = model.layers[0][0 if axis == "time" else 1].layers[0][0].rotary_embed
        got = rope.rotate(x[None, None])[0, 0].numpy()
    else:
        got = P.rope(x[None, None])[0, 0].numpy()
    want = _closed_form_rope(x.numpy(), "interleaved")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(got - _closed_form_rope(x.numpy(), "split")).max() > 1e-2


def test_rope_positions_are_frames_in_time_layers_and_bands_in_band_layers():
    """Every time layer shares one embedding and every band layer another;
    the time layers turn by frame index (n = frames), the band layers by
    band index (n = bands)."""
    prog, _ = _pair()
    time_ropes = {id(blk[0].layers[0][0].rotary_embed) for blk in prog.layers}
    band_ropes = {id(blk[1].layers[0][0].rotary_embed) for blk in prog.layers}
    assert len(time_ropes) == len(band_ropes) == 1 and time_ropes != band_ropes
    lengths = {"time": set(), "band": set()}
    for axis, idx in (("time", 0), ("band", 1)):
        rope = prog.layers[0][idx].layers[0][0].rotary_embed
        orig = rope.cos_sin
        rope.cos_sin = lambda n, like, orig=orig, axis=axis: lengths[axis].add(n) or orig(n, like)
    with torch.no_grad():
        prog(_waves((2, 4000)))
    assert lengths == {"time": {1 + 4000 // TINY["stft_hop_length"]}, "band": {len(BANDS)}}


@pytest.mark.parametrize("side", ["program", "reference"])
def test_rmsnorm_against_its_closed_form(side):
    """x / sqrt(mean(x^2)) * gamma over the last axis."""
    norm = (R if side == "program" else P).RMSNorm(24).double()
    with torch.no_grad():
        norm.gamma.copy_(torch.linspace(0.5, 1.5, 24, dtype=torch.float64))
    x = torch.randn(5, 7, 24, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    want = x / torch.sqrt((x * x).mean(dim=-1, keepdim=True)) * norm.gamma
    with torch.no_grad():
        assert torch.allclose(norm(x), want, rtol=1e-13, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)],
                         ids=["float64", "float32"])
def test_identity_mask_gives_the_waveform_back(dtype, tol):
    """Mask layers that give 1 + 0j (last layer's weights 0, bias 1 on the
    real slots and an open gate): iSTFT(STFT(x)) = x, whatever the rest of
    the weights (Hann window, hop 110 of 512)."""
    prog, _ = _pair()
    with torch.no_grad():
        for mlp in prog.mask_estimators[0].to_freqs:
            last = mlp[0][-1]
            last.weight.zero_()
            half = last.bias.shape[0] // 2
            last.bias.zero_()
            last.bias[:half:2] = 1.0
            last.bias[half:] = 30.0
    prog.to(dtype)
    x = _waves((2, 4321), seed=4).to(dtype)
    with torch.no_grad():
        assert _rel(prog(x), x) <= tol


def _band_rope_left_out(model, monkeypatch):
    monkeypatch.setattr(model.layers[0][1].layers[0][0].rotary_embed, "rotate", lambda t: t)


def _axes_swapped_in_one_block(model, monkeypatch):
    block = model.layers[1]
    model.layers[1] = nn.ModuleList([block[1], block[0]])  # the test's own model


def _band_fed_its_neighbours_slice(model, monkeypatch):
    split = model.band_split

    def forward(x):
        parts = list(x.split(split.dim_inputs, dim=-1))
        parts[7] = parts[8]  # two 16-value bands
        return torch.stack([f(p) for p, f in zip(parts, split.to_features)], dim=-2)

    monkeypatch.setattr(split, "forward", forward)


@pytest.mark.parametrize("fault", [_band_rope_left_out, _axes_swapped_in_one_block,
                                   _band_fed_its_neighbours_slice])
def test_planted_faults_move_the_output(fault, monkeypatch):
    prog, _ = _pair()
    x = _waves((2, 4000), seed=3)
    with torch.no_grad():
        sound = prog(x)
        fault(prog, monkeypatch)
        faulty = prog(x)
    assert _rel(faulty, sound) >= FAULT_MOVE


@pytest.mark.parametrize("key,value", [
    ("stereo", True), ("num_stems", 2), ("linear_transformer_depth", 1), ("attn_dropout", 0.1),
    ("ff_dropout", 0.1), ("stft_normalized", True),
])
def test_keys_left_out_raise(key, value):
    with pytest.raises(ValueError, match=key):
        BSRoformer(**dict(TINY, **{key: value}))


def test_unknown_keyword_and_two_channels_raise():
    with pytest.raises(TypeError, match="dim_typo"):
        BSRoformer(**dict(TINY, dim_typo=1))
    prog, _ = _pair()
    with pytest.raises(ValueError, match="one audio channel"):
        prog(torch.zeros(1, 2, 4000))


def test_analyzer_takes_the_bs_roformer_hook():
    """``AudfprintPeaks(denoising_model="bs_roformer")`` gives the peak
    masks of the reference's denoised waveform through the plain
    analyzer."""
    prog, ref = _pair(seed=8)
    params = afp_settings["audfprint"]
    x = _waves((3, 4000), seed=11)
    den = AudfprintPeaks(params, denoising=True, denoising_model="bs_roformer",
                         wave_denoiser=convert.bs_roformer_denoiser(prog), device="cpu")
    plain = AudfprintPeaks(params, device="cpu")
    with torch.no_grad():
        want = plain.peaks_batch(ref(x))
    assert torch.equal(den.peaks_batch(x), want)
    assert not torch.equal(plain.peaks_batch(x), want)
    with pytest.raises(ValueError, match="bs_roformer denoising requires wave_denoiser"):
        AudfprintPeaks(params, denoising=True, denoising_model="bs_roformer", device="cpu")


def test_dejavu_takes_the_bs_roformer_hook():
    """Dejavu denoises the raw waveform with BS-RoFormer as with Demucs:
    the batched masks of a denoising engine are the plain engine's masks
    of the reference's output, and the per-file ``read`` gives the hook's
    output."""
    prog, ref = _pair(seed=9)
    hook = convert.bs_roformer_denoiser(prog)
    st = afp_settings["dejavu"]
    den = Dejavu({}, st, denoising=True, denoising_model="bs_roformer", wave_denoiser=hook,
                 device="cpu")
    plain = Dejavu({}, st, device="cpu")
    x = _waves((2, 4000), seed=13)
    with torch.no_grad():
        clean = ref(x)
    got_masks, got_sgrams = dejavu_exps._masks_sgrams(den, x.numpy())
    want_masks, want_sgrams = dejavu_exps._masks_sgrams(plain, clean.numpy())
    assert torch.equal(got_masks, want_masks)
    assert _rel(got_sgrams, want_sgrams) <= 1e-4
    channels, sr, _ = read(x[0].numpy(), denoising=True, denoising_model="bs_roformer",
                           wave_denoiser=hook, sample_rate=SR, device="cpu")
    assert sr == SR
    np.testing.assert_allclose(channels[0], hook(x[:1])[0].numpy() * 32767.0, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="bs_roformer denoising requires wave_denoiser"):
        read(x[0].numpy(), denoising=True, denoising_model="bs_roformer", device="cpu")


def test_spans_and_token_count_under_a_profile():
    prog, _ = _pair()
    hook = convert.bs_roformer_denoiser(prog)
    x = _waves((3, 4000), seed=1)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        hook(x)
        hook(x)
    spans = profiling.spans()
    profiling.reset()
    roots = [s for s in spans if s["name"] == "denoiser.forward"]
    assert len(roots) == 2
    names = ["bsroformer.stft", "bsroformer.band_split", "bsroformer.transformer",
             "bsroformer.mask", "bsroformer.istft"]
    frames = 1 + 4000 // TINY["stft_hop_length"]
    for root in roots:
        children = [s for s in spans if s["parent"] == root["id"]]
        assert [s["name"] for s in children] == names
        counted = [s["counts"] for s in children if s["counts"]]
        assert counted == [{"bsroformer.tokens": 3 * frames * len(BANDS)}]
    # nothing recorded without a profile
    hook(x)
    assert profiling.spans() == [] and profiling.counters() == {}


def test_tf32_switch_is_held_off_and_restored():
    prog, _ = _pair()
    seen = []
    block = prog.layers[0][0]
    orig = block.forward

    def spy(x):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return orig(x)

    block.forward = spy
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            prog(_waves((1, 4000)))
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
def test_published_widths_on_card_match_the_reference():
    """At the published widths on two 8 s queries, the card's program
    against the reference on the card, both strict float32: within 2e-5 of
    the output's peak (the CPU's float32 tolerance; the card reads ~2e-7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the published widths are measured on the card")
    prog, ref = BSRoformer(**PUBLISHED).eval(), P.BSRoformer(**PUBLISHED).eval()
    w = _weights(ref, 21)
    prog.load_state_dict(w)
    ref.load_state_dict(w)
    prog, ref = prog.cuda(), ref.cuda()
    x = _waves((2, 8 * SR), seed=21).cuda()
    with torch.no_grad():
        got = convert.bs_roformer_denoiser(prog)(x)
        want = ref(x)
    assert _rel(got, want) <= F32_TOL

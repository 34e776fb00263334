"""The port's Hybrid Transformer Demucs against the plain reference
(``portbench/ref/models/htdemucs.py``, the benchmark's frozen reference,
loaded by path: the published forward written in plain PyTorch,
attention as softmax(Q K^T / sqrt(d)) V, the iSTFT written out), on seeded
random weights at small widths (channels 8, depth 2, nfft 256, three
Transformer layers of two heads), on the CPU. The JAX package has no
HTDemucs.

Tolerances, of the output's peak: 1e-10 in float64 (the two forwards differ
only in the order of their sums: the fused attention against the written-out
softmax, ``torch.istft`` against the written-out overlap-add; under
1e-15 read); 2e-5 in float32 (float32's 6e-8 over sums of up to 256 terms
through eight convolution and twelve attention and FFN layers; 3e-7 read).
Each planted fault has to move the output by at least ten times the
float32 tolerance (0.10 to 0.40 read).
Also: the published configuration on the meta device, the sinusoidal
embeddings against their closed forms, the keywords left out, the
audfprint and Dejavu waveform hooks, and the spans and the token counter.
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
from musicfpaugment_torch.models import HTDemucs
from musicfpaugment_torch.models import htdemucs as H
from musicfpaugment_torch.testing import dejavu_exps
from musicfpaugment_torch.testing.parameters import afp_settings
from musicfpaugment_torch.utils import profiling

from torch_threads import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")


def _load_reference():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "portbench", "ref", "models", "htdemucs.py")
    spec = importlib.util.spec_from_file_location("plain_htdemucs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


P = _load_reference()

F64_TOL = 1e-10
F32_TOL = 2e-5
FAULT_MOVE = 10 * F32_TOL
SR = 8000
TINY = dict(sources=["music"], audio_channels=1, channels=8, depth=2, nfft=256, t_layers=3,
            t_heads=2, samplerate=SR, segment=0.5)
# an 8 s query at the published widths: 8 bins x 63 frames and 250 steps
PUBLISHED_TOKENS = (504, 250)


def _weights(model: nn.Module, seed: int) -> dict:
    """Seeded weights: matrices and kernels at their fan-in's scale, norm
    scales near 1, every other leaf (biases, LayerScales, the packed
    in-projection's bias, the frequency embedding's) at 0.1."""
    norms = {n for n, m in model.named_modules() if isinstance(m, (nn.LayerNorm, nn.GroupNorm))}
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        z = torch.randn(v.shape, generator=gen)
        if k.rsplit(".", 1)[0] in norms:
            out[k] = 1.0 + 0.1 * z if k.endswith("weight") else 0.1 * z
        elif k.endswith("weight") and v.dim() >= 2:
            out[k] = z * math.sqrt(2.0 / v[0].numel())
        else:
            out[k] = 0.1 * z
    return out


def _pair(seed: int = 5, **kw):
    """(program, reference) in evaluation on the same weights."""
    args = dict(TINY, **kw)
    prog, ref = HTDemucs(**args).eval(), P.HTDemucs(**args).eval()
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


@pytest.mark.parametrize("shape", [(2, 4000), (2, 1, 4000), (3, 2600), (2, 5111)],
                         ids=["segment", "channel_axis", "padded_to_segment", "past_segment"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, F64_TOL), (torch.float32, F32_TOL)],
                         ids=["float64", "float32"])
def test_program_matches_plain_reference(shape, dtype, tol):
    prog, ref = _pair()
    prog.to(dtype)
    ref.to(dtype)
    x = _waves(shape, seed=len(shape) + shape[-1]).to(dtype)
    with torch.no_grad():
        got, want = prog(x), ref(x)
    assert got.shape == want.shape == (shape if len(shape) == 2 else (shape[0], 1, 1, shape[-1]))
    assert got.dtype == dtype
    assert _rel(got, want) <= tol


def test_published_configuration_on_the_meta_device():
    """The published widths: (B, 504, 384) spectral and (B, 250, 384)
    temporal tokens for an 8 s, 8 kHz query, five Transformer layers that
    alternate self- and cross-attention, and the same parameters by name
    and shape as the reference."""
    args = dict(sources=["music"], audio_channels=1, samplerate=SR, segment=8)
    with torch.device("meta"):
        prog, ref = HTDemucs(**args), P.HTDemucs(**args)
    assert {k: v.shape for k, v in prog.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}
    assert sum(p.numel() for p in prog.parameters()) == sum(p.numel() for p in ref.parameters())
    assert "crosstransformer.layers.1.cross_attn.in_proj_weight" in prog.state_dict()
    kinds = [type(m).__name__ for m in prog.crosstransformer.layers]
    assert kinds == ["MyTransformerEncoderLayer", "CrossTransformerEncoderLayer"] * 2 + \
        ["MyTransformerEncoderLayer"]
    seen = {}

    class Seen(Exception):
        pass

    def spectral(mod, args):
        seen["x"] = tuple(args[0].shape)

    def temporal(mod, args):
        seen["xt"] = tuple(args[0].shape)
        raise Seen

    prog.crosstransformer.layers[0].register_forward_pre_hook(spectral)
    prog.crosstransformer.layers_t[0].register_forward_pre_hook(temporal)
    with pytest.raises(Seen):
        prog(torch.empty(2, 8 * SR, device="meta"))
    assert seen == {"x": (2, PUBLISHED_TOKENS[0], 384), "xt": (2, PUBLISHED_TOKENS[1], 384)}
    out = ref.eval()(torch.empty(2, 8 * SR, device="meta"))
    assert out.shape == (2, 8 * SR)


@pytest.mark.parametrize("side", ["program", "reference"])
def test_sin_embeddings_against_their_closed_forms(side):
    if side == "program":
        one = H.sin_embedding(250, 384)
        two = H.sin_embedding_2d(384, 8, 63)
    else:
        one = P.create_sin_embedding(250, 384)[:, 0]
        two = P.create_2d_sin_embedding(384, 8, 63)[0]
    half = 192
    for t, i in [(0, 0), (1, 0), (7, 5), (249, 191), (100, 64)]:
        phase = t / 10000 ** (i / (half - 1))
        assert float(one[t, i]) == pytest.approx(math.cos(phase), abs=2e-5)
        assert float(one[t, half + i]) == pytest.approx(math.sin(phase), abs=2e-5)
    for f, t, k in [(0, 0, 0), (3, 62, 0), (7, 10, 47), (5, 33, 20)]:
        rate = math.exp(-2 * k * math.log(10000) / half)
        assert float(two[2 * k, f, t]) == pytest.approx(math.sin(t * rate), abs=2e-5)
        assert float(two[2 * k + 1, f, t]) == pytest.approx(math.cos(t * rate), abs=2e-5)
        assert float(two[half + 2 * k, f, t]) == pytest.approx(math.sin(f * rate), abs=2e-5)
        assert float(two[half + 2 * k + 1, f, t]) == pytest.approx(math.cos(f * rate), abs=2e-5)


def _cross_attention_skipped(monkeypatch):
    def forward(self, q, k):
        x = q + self.gamma_2(self._ff_block(self.norm3(q)))
        return self.norm_out(x)

    monkeypatch.setattr(H.CrossTransformerEncoderLayer, "forward", forward)


def _spectral_output_dropped(monkeypatch):
    monkeypatch.setattr(H.HTDemucs, "_ispec",
                        lambda self, z, length: torch.zeros(z.shape[:-2] + (length,)))


def _embedding_axes_swapped(monkeypatch):
    orig = H.sin_embedding_2d

    def swapped(d_model, height, width, max_period=10000):
        pe = orig(d_model, height, width, max_period)
        return torch.cat([pe[d_model // 2:], pe[: d_model // 2]])

    monkeypatch.setattr(H, "sin_embedding_2d", swapped)


@pytest.mark.parametrize("fault", [_cross_attention_skipped, _spectral_output_dropped,
                                   _embedding_axes_swapped])
def test_planted_faults_move_the_output(fault, monkeypatch):
    prog, _ = _pair()
    x = _waves((2, 4000), seed=3)
    with torch.no_grad():
        sound = prog(x)
        fault(monkeypatch)
        prog, _ = _pair()
        faulty = prog(x)
    assert _rel(faulty, sound) >= FAULT_MOVE


@pytest.mark.parametrize("key,value", [
    ("wiener_iters", 1), ("end_iters", 1), ("multi_freqs", [4]), ("t_sparse_self_attn", True),
    ("t_sparse_cross_attn", True), ("t_emb", "cape"), ("t_emb", "scaled"),
    ("bottom_channels", 512), ("cac", False), ("t_cross_first", True),
])
def test_keys_left_out_raise(key, value):
    with pytest.raises(ValueError, match=key):
        HTDemucs(**dict(TINY, **{key: value}))


def test_unknown_keyword_raises():
    with pytest.raises(TypeError, match="nfft_typo"):
        HTDemucs(**dict(TINY, nfft_typo=1))


def test_analyzer_takes_the_htdemucs_hook():
    """``AudfprintPeaks(denoising_model="htdemucs")`` gives the peak masks
    of the reference's denoised waveform through the plain analyzer."""
    prog, ref = _pair(seed=8)
    params = afp_settings["audfprint"]
    x = _waves((3, 4000), seed=11)
    den = AudfprintPeaks(params, denoising=True, denoising_model="htdemucs",
                         wave_denoiser=convert.htdemucs_denoiser(prog), device="cpu")
    plain = AudfprintPeaks(params, device="cpu")
    with torch.no_grad():
        want = plain.peaks_batch(ref(x))
    assert torch.equal(den.peaks_batch(x), want)
    assert not torch.equal(plain.peaks_batch(x), want)
    with pytest.raises(ValueError, match="htdemucs denoising requires wave_denoiser"):
        AudfprintPeaks(params, denoising=True, denoising_model="htdemucs", device="cpu")


def test_dejavu_takes_the_htdemucs_hook():
    """Dejavu denoises the raw waveform with HTDemucs as with Demucs: the
    batched masks of a denoising engine are the plain engine's masks of the
    reference's output, and the per-file ``read`` gives the hook's output."""
    prog, ref = _pair(seed=9)
    hook = convert.htdemucs_denoiser(prog)
    st = afp_settings["dejavu"]
    den = Dejavu({}, st, denoising=True, denoising_model="htdemucs", wave_denoiser=hook,
                 device="cpu")
    plain = Dejavu({}, st, device="cpu")
    x = _waves((2, 4000), seed=13)
    with torch.no_grad():
        clean = ref(x)
    got_masks, got_sgrams = dejavu_exps._masks_sgrams(den, x.numpy())
    want_masks, want_sgrams = dejavu_exps._masks_sgrams(plain, clean.numpy())
    assert torch.equal(got_masks, want_masks)
    assert _rel(got_sgrams, want_sgrams) <= 1e-4
    channels, sr, _ = read(x[0].numpy(), denoising=True, denoising_model="htdemucs",
                           wave_denoiser=hook, sample_rate=SR, device="cpu")
    assert sr == SR
    np.testing.assert_allclose(channels[0], hook(x[:1])[0].numpy() * 32767.0, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="htdemucs denoising requires wave_denoiser"):
        read(x[0].numpy(), denoising=True, denoising_model="htdemucs", device="cpu")


def test_spans_and_token_count_under_a_profile():
    prog, _ = _pair()
    hook = convert.htdemucs_denoiser(prog)
    x = _waves((3, 4000), seed=1)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        hook(x)
        hook(x)
    spans = profiling.spans()
    profiling.reset()
    roots = [s for s in spans if s["name"] == "denoiser.forward"]
    assert len(roots) == 2
    names = ["htdemucs.spec", "htdemucs.encoder", "htdemucs.transformer", "htdemucs.decoder",
             "htdemucs.ispec"]
    for root in roots:
        children = [s for s in spans if s["parent"] == root["id"]]
        assert [s["name"] for s in children] == names
        counted = [s["counts"] for s in children if s["counts"]]
        assert counted == [{"htdemucs.tokens": 3 * sum(PUBLISHED_TOKENS)}]
    # nothing recorded without a profile
    hook(x)
    assert profiling.spans() == [] and profiling.counters() == {}


def test_tf32_switches_are_held_off_and_restored():
    prog, _ = _pair()
    seen = []
    orig = prog.crosstransformer.forward

    def spy(x, xt):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return orig(x, xt)

    prog.crosstransformer.forward = spy
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            prog(_waves((1, 4000)))
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
    assert torch.backends.cudnn.allow_tf32 == before[1]


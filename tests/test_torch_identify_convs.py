"""cuDNN's flags around the identify hooks' convolutions: ``unet_denoiser``,
``demucs_denoiser`` and ``htdemucs_denoiser`` run their model under
``device.cudnn_measured`` (TF32 off, engines chosen by timing the first
``MEASURED_ENGINES`` candidates); every flag is restored, also after a
forward that raises; ``denoiser.tuned_shapes`` counts a hook's calls on a
shape it has not met before; the output is the model's own, bit for bit.
The spies record the flags the convolutions see (on the CPU the flags are
set and read as on the card; cuDNN does not run).

The ``cuda``-marked test runs the UNet hook at its published width on the
card, timed and by cuDNN's heuristic, each in its own process. The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_identify_convs.py --noconftest -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from musicfpaugment_torch import convert
from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.device import MEASURED_ENGINES
from musicfpaugment_torch.models import Demucs, HTDemucs, UNet
from musicfpaugment_torch.testing.parameters import afp_settings
from musicfpaugment_torch.utils import profiling

from torch_threads import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
N_HOP = 256
CONVS = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Conv1d, torch.nn.ConvTranspose1d)
DEFAULTS = (True, False, 10, False, True)  # PyTorch's cuDNN flags
KINDS = ("unet", "demucs", "htdemucs")


@pytest.fixture
def flags(monkeypatch):
    """A reader of cuDNN's flags (enabled, benchmark, benchmark_limit,
    deterministic, allow_tf32). Where cuDNN is absent PyTorch keeps no
    ``benchmark_limit`` (it reads None and is never set), so a stand-in
    store behind ``cudnn.set_flags``, which ``cudnn.flags`` calls, keeps it
    as the card does."""
    c = torch.backends.cudnn
    if c.is_available():
        read_limit = lambda: c.benchmark_limit
    else:
        store = [10]
        monkeypatch.setitem(c.set_flags.__globals__, "is_available", lambda: True)
        monkeypatch.setattr(torch._C, "_cuda_get_cudnn_benchmark_limit", lambda: store[0],
                            raising=False)
        monkeypatch.setattr(torch._C, "_cuda_set_cudnn_benchmark_limit",
                            lambda n: store.__setitem__(0, n), raising=False)
        read_limit = lambda: store[0]
    return lambda: (c.enabled, c.benchmark, read_limit(), c.deterministic, c.allow_tf32)


def _model(kind):
    """A tiny model of ``kind``, its hook and two inputs of different shapes."""
    torch.manual_seed(0)
    if kind == "unet":
        model, make = UNet(1, 1, base=4), convert.unet_denoiser
        shapes = ((2, 33, 17), (2, 33, 16))
    elif kind == "demucs":
        model, make = Demucs(hidden=4, depth=2), convert.demucs_denoiser
        shapes = ((2, 2000), (2, 1800))
    else:
        model = HTDemucs(sources=["music"], audio_channels=1, channels=8, depth=2, nfft=256,
                         t_layers=1, t_heads=2, samplerate=SR, segment=0.5)
        make = convert.htdemucs_denoiser
        shapes = ((2, 4000), (2, 3000))
    gen = torch.Generator().manual_seed(1)
    return model, make(model), [torch.rand(s, generator=gen) for s in shapes]


def _spy_convs(model, seen, flags):
    """Record the (TF32, ``benchmark``, ``benchmark_limit``) flags each
    convolution's forward sees."""
    def record(*_):
        _, benchmark, limit, _, allow_tf32 = flags()
        seen.append((allow_tf32, benchmark, limit))

    handles = [m.register_forward_pre_hook(record) for m in model.modules()
               if isinstance(m, CONVS)]
    return handles


@pytest.mark.parametrize("kind", KINDS)
def test_hook_convolutions_are_measured_and_the_output_is_the_models(kind, flags):
    """Every convolution of the hook's forward sees TF32 off, ``benchmark``
    on and ``benchmark_limit`` at ``MEASURED_ENGINES``; the flags are
    PyTorch's defaults again after the call, and the output is the model's
    own forward, bit for bit."""
    model, hook, (x, _) = _model(kind)
    seen = []
    handles = _spy_convs(model, seen, flags)
    assert flags() == DEFAULTS
    got = hook(x)
    assert handles and len(seen) >= len(handles)
    assert set(seen) == {(False, True, MEASURED_ENGINES)}
    assert flags() == DEFAULTS
    for h in handles:
        h.remove()
    with torch.inference_mode():
        want = model(x).to(torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("before", [DEFAULTS, (True, True, 3, True, False)], ids=["defaults", "set"])
@pytest.mark.parametrize("kind", KINDS)
def test_flags_are_restored_after_a_call_and_after_one_that_raises(kind, before, flags):
    model, hook, (x, _) = _model(kind)
    c = torch.backends.cudnn
    enabled, benchmark, limit, deterministic, allow_tf32 = before
    with c.flags(enabled=enabled, benchmark=benchmark, benchmark_limit=limit,
                 deterministic=deterministic, allow_tf32=allow_tf32):
        assert flags() == before
        hook(x)
        assert flags() == before

        def boom(*_):
            assert flags()[1:] == (True, MEASURED_ENGINES, deterministic, False)
            raise RuntimeError("conv")

        conv = next(m for m in model.modules() if isinstance(m, CONVS))
        handle = conv.register_forward_pre_hook(boom)
        try:
            with pytest.raises(RuntimeError, match="conv"):
                hook(x)
        finally:
            handle.remove()
        assert flags() == before
    assert flags() == DEFAULTS


def _tuned(calls):
    """``denoiser.tuned_shapes`` added by each of ``calls``, under a
    profile (the counter counts only there)."""
    counted = []
    profiling.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for call in calls:
                before = profiling.counters().get("denoiser.tuned_shapes", 0)
                call()
                counted.append(profiling.counters().get("denoiser.tuned_shapes", 0) - before)
    finally:
        profiling.reset()
    return counted


@pytest.mark.parametrize("kind", KINDS)
def test_tuned_shapes_counts_each_new_input_shape_once(kind):
    """A hook counts a shape the first time it meets it, not on a repeat; a
    second hook of the same model keeps its own shapes. Without a profile
    nothing is counted."""
    model, hook, (a, b) = _model(kind)
    other = {"unet": convert.unet_denoiser, "demucs": convert.demucs_denoiser,
             "htdemucs": convert.htdemucs_denoiser}[kind](model)
    calls = [lambda: hook(a), lambda: hook(a), lambda: hook(b), lambda: hook(a),
             lambda: hook(b), lambda: other(b), lambda: other(a)]
    assert _tuned(calls) == [1, 0, 1, 0, 0, 1, 1]
    hook(torch.rand(a.shape[0] + 1, *a.shape[1:]))
    assert profiling.counters() == {}


def test_a_four_shift_match_counts_the_two_frame_counts_of_its_shifts():
    """``match_waveforms`` calls the spectrogram hook once a shift; a query
    of a whole number of hops gives 41 frames at shift 0 and 40 at the
    other three, so the hook meets two shapes: 2, then 0 on a second call."""
    torch.manual_seed(0)
    hook = convert.unet_denoiser(UNet(1, 1, base=4))
    tracks = next(synthetic_clean_batches(2, 6 * SR, seed=31, sample_rate=SR))
    ht = HashTable(hashbits=16, depth=8)
    AudfprintPeaks(afp_settings["audfprint"], device="cpu").ingest_batch(ht, ["a", "b"], tracks)
    crops = np.stack([t[SR:][: 40 * N_HOP] for t in tracks])
    frames = []
    dm = DeviceMatcher(ht, device="cpu")

    def seen(sgram):
        frames.append(int(sgram.shape[-1]))
        return hook(sgram)

    call = lambda: dm.match_waveforms(crops, shifts=4, denoiser=seen)
    assert _tuned([call, call]) == [2, 0]
    assert frames == [41, 40, 40, 40] * 2


# ------------------------------------------------------------ on the card

CARD_SHAPE = (16, 257, 251)
CARD_REL = 1e-6


def _card_output(route, out):
    """The UNet hook at its published width (base 64, seeded initial
    weights, in evaluation) on 16 x 257 x 251 normalised magnitudes, through ``route``: ``measured``
    (the hook as it is) or ``heuristic`` (TF32 off, cuDNN's heuristic).
    Saves the output to ``out``; returns the flags the convolutions saw."""
    from musicfpaugment_torch import device as D

    if route == "heuristic":
        convert.cudnn_measured = lambda: D.cudnn_tf32(False, benchmark=False)
    torch.manual_seed(22)
    model = UNet(1, 1, base=64).cuda()
    hook = convert.unet_denoiser(model)
    seen = []
    c = torch.backends.cudnn
    _spy_convs(model, seen, lambda: (c.enabled, c.benchmark, c.benchmark_limit,
                                     c.deterministic, c.allow_tf32))
    gen = torch.Generator().manual_seed(23)
    x = torch.rand(CARD_SHAPE, generator=gen).cuda()
    torch.save(hook(x).cpu(), out)
    return sorted(set(seen))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cuDNN's engines run on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_measured_hook_on_card_agrees_with_the_heuristic(cuda_device, tmp_path):
    """Each route in a process of its own (cuDNN keeps one engine a
    convolution problem a process, whichever route chose it): the timed
    engines' output is within 1e-6 of its largest value of the
    heuristic's."""
    flags, outs = {}, {}
    for route in ("measured", "heuristic"):
        outs[route] = str(tmp_path / f"{route}.pt")
        code = ("import json, sys; sys.path.insert(0, 'tests'); "
                "import test_torch_identify_convs as t; "
                f"print(json.dumps(t._card_output({route!r}, {outs[route]!r})))")
        run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             timeout=600,
                             cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert run.returncode == 0, run.stderr[-4000:]
        flags[route] = json.loads(run.stdout.strip().splitlines()[-1])
    assert flags["measured"] == [[False, True, MEASURED_ENGINES]], flags
    assert flags["heuristic"] == [[False, False, 10]], flags
    m, h = torch.load(outs["measured"]), torch.load(outs["heuristic"])
    assert m.shape == CARD_SHAPE and bool(torch.isfinite(m).all())
    rel = float((m - h).abs().max()) / float(h.abs().max())
    print(f"measured against heuristic: {rel:.3e} of the largest output")
    assert rel < CARD_REL, rel

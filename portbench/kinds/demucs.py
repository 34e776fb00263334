"""Demucs on waveforms (``models/demucs.py``): the program's module and its
hook, the frozen reference, the identify cells' near-identity weights and
the FLOPs of one identify batch (``kinds/unet.py`` says what a kind file
gives)."""

from __future__ import annotations

import contextlib
from typing import Dict
from unittest import mock

import torch

from portbench import inputs as I

# what the hook maps: the (B, T) query waveforms, before the frontend
DOMAIN = "waveform"
# the CPU tests' sizes (``tests/tiny.py``)
TINY_ARGS = {"hidden": 16, "depth": 3, "sample_rate": 8000}
# a GLU gate's bias that holds it open: its sigmoid is 1 in float32
GATE_OPEN = 20.0


def program_model(args: dict) -> torch.nn.Module:
    from musicfpaugment_torch.models import Demucs

    return Demucs(**args)


def reference_model(args: dict) -> torch.nn.Module:
    from portbench.ref.models.demucs import Demucs

    return Demucs(**args)


def program_arm(model: torch.nn.Module, settings: dict, device: str):
    """The program's denoised analyzer: ``model``'s waveform hook in
    ``AudfprintPeaks``."""
    from musicfpaugment_torch import convert
    from musicfpaugment_torch.afp.audfprint.analyzer import AudfprintPeaks

    return AudfprintPeaks(settings, denoising=True, denoising_model="demucs",
                          wave_denoiser=convert.demucs_denoiser(model), device=device)


def batch_flops(config: dict, B: int) -> int:
    """One identify batch: the model once on the (B, T) queries."""
    s = config["audfprint"]
    return I.forward_flops(config, (B, config["query_seconds"] * s["samplerate"]))


def tf32() -> contextlib.AbstractContextManager:
    """The control: the reference's own strict-float32 switch lets cuDNN's
    TF32 through (its convolutions and the cuDNN LSTM)."""
    from portbench.ref import device as D
    from portbench.ref.models import demucs as RD

    return mock.patch.object(RD, "cudnn_tf32", lambda _allow: D.cudnn_tf32(True))


def near_identity(state: Dict[str, torch.Tensor], args: dict) -> None:
    """Encoder 0 and the output decoder carry the (resampled) waveform by a
    perfect-reconstruction pair at stride ``S`` and kernel ``2 S``: tap ``t``
    of the analysis is its own channel pair (+ and - through the ReLU),
    weighted by the sine window ``w``, ``w[t]^2 + w[t + S]^2 = 1``; the
    GLUs' gates on those channels are held open, and the last transposed
    convolution sums the taps back with ``w``. Those two layers carry the
    rest of :func:`inputs.weights` at :data:`inputs.PERTURBATION`; the deep
    path (encoders 1 on, the LSTM, the other decoders) keeps the full scale
    of :func:`inputs.weights` and adds to the last decoder's input: about a
    tenth of the output, so that a fault in it shows (zeroing the LSTM
    moves the output by 6-8e-4 of its peak; the hashes stay within some
    percent of the input's)."""
    K, S = int(args.get("kernel_size", 8)), int(args.get("stride", 4))
    H = int(args.get("hidden", 48))
    depth = int(args.get("depth", 5))
    if K != 2 * S or H < 2 * K:
        raise ValueError(f"no near-identity Demucs for kernel {K}, stride {S}, hidden {H}")
    last = f"decoder.{depth - 1}."
    for k, v in state.items():
        if k.startswith(("encoder.0.", last)):
            v.mul_(I.PERTURBATION)
    dev = state["encoder.0.0.weight"].device
    t = torch.arange(K, device=dev)
    w = torch.sin(torch.pi * (t + 0.5) / K)
    enc, glu = state["encoder.0.0.weight"], state["encoder.0.2.weight"]
    enc[2 * t, 0, t] += w
    enc[2 * t + 1, 0, t] -= w
    glu[t, 2 * t, 0] += 1.0
    glu[t, 2 * t + 1, 0] -= 1.0
    state["encoder.0.2.bias"][H + t] += GATE_OPEN
    state[last + "0.weight"][t, t, 0] += 1.0
    state[last + "0.bias"][H + t] += GATE_OPEN
    state[last + "2.weight"][t, 0, t] += w

"""The UNet on normalised magnitude spectrograms (``models/unet.py``): the
program's module and its hook, the frozen reference, the identify cells'
near-identity weights and the FLOPs of one identify batch.

A denoiser kind is a file ``kinds/<config's "model">.py`` with what this one
gives; the harness finds it by that name (``inputs.kind``)."""

from __future__ import annotations

import contextlib
from typing import Dict
from unittest import mock

import torch

from portbench import inputs as I

# what the hook maps: each shift's (B, F, C) normalised magnitudes
DOMAIN = "spectrogram"
# the CPU tests' sizes (``tests/tiny.py``)
TINY_ARGS = {"n_channels": 1, "n_classes": 1, "base": 4, "bilinear": False, "rate": 0.05}


def program_model(args: dict) -> torch.nn.Module:
    from musicfpaugment_torch.models import UNet

    return UNet(**args)


def reference_model(args: dict) -> torch.nn.Module:
    from portbench.ref.models.unet import UNet

    return UNet(**args)


def program_arm(model: torch.nn.Module, settings: dict, device: str):
    """The program's denoised analyzer: ``model``'s spectrogram hook in
    ``AudfprintPeaks``."""
    from musicfpaugment_torch import convert
    from musicfpaugment_torch.afp.audfprint.analyzer import AudfprintPeaks

    return AudfprintPeaks(settings, denoising=True, denoising_model="unet",
                          spec_denoiser=convert.unet_denoiser(model), device=device)


def batch_flops(config: dict, B: int) -> int:
    """One identify batch: the model on every shift's (B, n_fft / 2 + 1,
    frames) spectrogram, each shift counted at the first shift's frames."""
    s = config["audfprint"]
    frames = 1 + config["query_seconds"] * s["samplerate"] // s["n_hop"]
    return I.forward_flops(config, (B, s["n_fft"] // 2 + 1, frames)) * s["shifts"]


def tf32() -> contextlib.AbstractContextManager:
    """The control: the reference's own strict-float32 switch lets cuDNN's
    TF32 through (the model's work is all convolutions)."""
    from portbench.ref import device as D
    from portbench.ref.models import unet as RU

    return mock.patch.object(RU, "cudnn_tf32", lambda _allow: D.cudnn_tf32(True))


def near_identity(state: Dict[str, torch.Tensor], args: dict) -> None:
    """Every weight of :func:`inputs.weights` at :data:`inputs.PERTURBATION`,
    every BatchNorm the identity in evaluation, and the identity along the
    skip path: the centre taps of ``inc``, of ``up4``'s convolutions on the
    skip's first channel and of ``outc``. (A deep path at full scale joined
    at :data:`inputs.PERTURBATION`, as Demucs has, moved the hashes by up to
    a quarter with the seed.)"""
    for k, v in state.items():
        if k.endswith("running_var"):
            v.fill_(1.0 - 1e-5)
        elif k.endswith("running_mean") or (k.endswith("bias") and ".bn" in k):
            v.zero_()
        elif ".bn" in k and k.endswith("weight"):
            v.fill_(1.0)
        elif v.is_floating_point():
            v.mul_(I.PERTURBATION)
    for conv in ("inc.conv1", "inc.conv2", "up4.conv.conv1", "up4.conv.conv2"):
        state[conv + ".weight"][0, 0, 1, 1] += 1.0
    state["outc.weight"][0, 0, 0, 0] += 1.0
    state["outc.bias"].zero_()

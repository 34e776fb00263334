"""Band-Split RoPE Transformer on waveforms (``models/bs_roformer.py``): the
program's module and its hook, the frozen reference, the identify cells'
near-identity weights and the FLOPs of one identify batch (``kinds/unet.py``
says what a kind file gives)."""

from __future__ import annotations

import contextlib
from typing import Dict
from unittest import mock

import torch

from portbench import inputs as I

# what the hook maps: the (B, T) query waveforms, before the frontend
DOMAIN = "waveform"
# the CPU tests' sizes (``tests/tiny.py``): the published layout's shape at a
# 512-point STFT (runs of equal bands widening, then two wide ones: 15 bands
# over 257 bins), the published ratio of hop to window (110 / 512), width 32,
# two axial blocks of two heads; an 8 s query is 582 frames x 15 bands
TINY_ARGS = {"dim": 32, "depth": 2, "heads": 2, "dim_head": 16,
             "time_transformer_depth": 1, "freq_transformer_depth": 1,
             "freqs_per_bands": [4] * 6 + [8] * 3 + [16] * 2 + [32] * 2 + [56, 57],
             "stft_n_fft": 512, "stft_hop_length": 110, "stft_win_length": 512,
             "mask_estimator_depth": 2}
# a GLU gate's bias that holds it open: its sigmoid is 1 in float32
GATE_OPEN = 20.0
# the mask MLPs' last layer, of its seeded scale: with the band split and the
# axial blocks at full scale, the deep path moves the output by about a
# tenth (``near_identity``)
MASK_OUT = 0.1


def program_model(args: dict) -> torch.nn.Module:
    try:
        from musicfpaugment_torch.models import BSRoformer
    except ImportError as e:
        raise SystemExit(f"portbench: the program has no BS-RoFormer model "
                         f"(musicfpaugment_torch.models.BSRoformer): {e}") from e
    return BSRoformer(**args)


def reference_model(args: dict) -> torch.nn.Module:
    from portbench.ref.models.bs_roformer import BSRoformer

    return BSRoformer(**args)


def program_arm(model: torch.nn.Module, settings: dict, device: str):
    """The program's denoised analyzer: ``model``'s waveform hook in
    ``AudfprintPeaks``."""
    from musicfpaugment_torch import convert
    from musicfpaugment_torch.afp.audfprint.analyzer import AudfprintPeaks

    return AudfprintPeaks(settings, denoising=True, denoising_model="bs_roformer",
                          wave_denoiser=convert.bs_roformer_denoiser(model), device=device)


def attention_flops(config: dict, B: int) -> int:
    """What no module hook sees in the reference: Q K^T and A V of every
    attention layer, 2 x 2 x sequences x n^2 x heads x head width, from the
    (sequences, n, dim) each layer is handed on the meta device."""
    from portbench.ref.models import bs_roformer as RB

    s = config["audfprint"]
    model = I.reference_model(config)
    total = 0

    def products(mod, args):
        nonlocal total
        S, n, _ = args[0].shape
        total += 2 * 2 * S * n * n * mod.heads * mod.dim_head

    hooks = [m.register_forward_pre_hook(products) for m in model.modules()
             if isinstance(m, RB.Attention)]
    with torch.no_grad():
        model(torch.empty(B, config["query_seconds"] * s["samplerate"], device="meta"))
    for h in hooks:
        h.remove()
    return total


def batch_flops(config: dict, B: int) -> int:
    """One identify batch: the model once on the (B, T) queries: every
    ``nn.Linear`` (the band split, the projections, the feed-forwards, the
    mask MLPs), plus the attention's products on both axes."""
    s = config["audfprint"]
    return (I.forward_flops(config, (B, config["query_seconds"] * s["samplerate"]))
            + attention_flops(config, B))


def tf32() -> contextlib.AbstractContextManager:
    """The control: the reference's own strict-float32 switches let TF32
    through (cuBLAS's: the linear layers and the attention's products)."""
    from portbench.ref.models import bs_roformer as RB

    switches = RB.tf32_switches
    return mock.patch.object(RB, "tf32_switches", lambda _allow: switches(True))


def near_identity(state: Dict[str, torch.Tensor], args: dict) -> None:
    """A mask of 1 + 0j plus a seeded part: each band's last mask layer
    carries, in its bias, 1 on the real slots and 0 on the imaginary ones of
    the GLU's value half and :data:`GATE_OPEN` on its gate half, and its
    seeded weight and bias at :data:`MASK_OUT` of their scale. With the
    mask at 1, iSTFT(STFT(x)) = x (a Hann window at a hop under its length
    overlaps-adds to a positive envelope), so the output is the query moved
    by the deep path, about a tenth of it. Every RMSNorm scale ``gamma``
    (drawn as a bias, 0.1 z) is put near 1; the band split, the axial
    blocks and the mask MLPs' first layers keep the full scale of
    :func:`inputs.weights`."""
    last = 2 * (int(args.get("mask_estimator_depth", 2)) - 1)
    for k, v in state.items():
        if k.endswith(".gamma"):
            v.add_(1.0)
    heads = [k[: -len("weight")] for k in state
             if k.startswith("mask_estimators.0.to_freqs.") and k.endswith(f".0.{last}.weight")]
    if not heads:
        raise ValueError("no near-identity BS-RoFormer: no mask layer found")
    for pre in heads:
        state[pre + "weight"].mul_(MASK_OUT)
        bias = state[pre + "bias"].mul_(MASK_OUT)
        half = bias.shape[0] // 2
        bias[:half:2] += 1.0
        bias[half:] += GATE_OPEN

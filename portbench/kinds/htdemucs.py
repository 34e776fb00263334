"""Hybrid Transformer Demucs on waveforms (``models/htdemucs.py``): the
program's module and its hook, the frozen reference, the identify cells'
near-identity weights and the FLOPs of one identify batch (``kinds/unet.py``
says what a kind file gives)."""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple
from unittest import mock

import torch

from portbench import inputs as I

# what the hook maps: the (B, T) query waveforms, before the frontend
DOMAIN = "waveform"
# the CPU tests' sizes (``tests/tiny.py``): 16 channels in every layer,
# three Transformer layers of two heads; on an 8 s query 4 x 125 spectral
# and 250 temporal tokens
TINY_ARGS = {"sources": ["music"], "audio_channels": 1, "channels": 16, "growth": 1,
             "depth": 4, "nfft": 2048, "t_layers": 3, "t_heads": 2, "samplerate": 8000,
             "segment": 8}
# a GLU gate's bias that holds it open: its sigmoid is 1 in float32
GATE_OPEN = 20.0
# the spectral branch's outermost transposed convolution, of its seeded
# scale: with the deep temporal path at full scale, the two deep paths add
# about a tenth of the output (``near_identity``)
SPECTRAL_OUT = 0.1


def program_model(args: dict) -> torch.nn.Module:
    try:
        from musicfpaugment_torch.models import HTDemucs
    except ImportError as e:
        raise SystemExit(f"portbench: the program has no HTDemucs model "
                         f"(musicfpaugment_torch.models.HTDemucs): {e}") from e
    return HTDemucs(**args)


def reference_model(args: dict) -> torch.nn.Module:
    from portbench.ref.models.htdemucs import HTDemucs

    return HTDemucs(**args)


def program_arm(model: torch.nn.Module, settings: dict, device: str):
    """The program's denoised analyzer: ``model``'s waveform hook in
    ``AudfprintPeaks``."""
    from musicfpaugment_torch import convert
    from musicfpaugment_torch.afp.audfprint.analyzer import AudfprintPeaks

    return AudfprintPeaks(settings, denoising=True, denoising_model="htdemucs",
                          wave_denoiser=convert.htdemucs_denoiser(model), device=device)


def transformer_tokens(config: dict, B: int) -> Tuple[int, int, int]:
    """(width, spectral tokens, temporal tokens) an example, from the
    shapes the reference's Transformer is handed on the meta device."""
    s = config["audfprint"]
    model = I.reference_model(config)
    seen = {}

    def grab(mod, args):
        seen["x"], seen["xt"] = args[0].shape, args[1].shape

    hook = model.crosstransformer.register_forward_pre_hook(grab)
    with torch.no_grad():
        model(torch.empty(B, config["query_seconds"] * s["samplerate"], device="meta"))
    hook.remove()
    _, C, Fr, T1 = seen["x"]
    return C, Fr * T1, seen["xt"][-1]


def attention_flops(C: int, spec: int, temp: int, layers: int, B: int) -> int:
    """What no module hook sees in the reference's Transformer, each layer
    and branch: the packed in-projections (Q on the queries, K and V on the
    keys' branch), the out-projection, Q K^T and A V. The FFN's ``nn.Linear``
    layers are counted by the hooks."""
    total = 0
    for idx in range(layers):
        for q, kv in ((spec, temp), (temp, spec)):
            if idx % 2 == 0:
                kv = q  # self-attention within the branch
            total += 2 * B * (q * C * C + kv * C * 2 * C)  # in-projections
            total += 2 * B * q * C * C  # out-projection
            total += 2 * 2 * B * q * kv * C  # Q K^T and A V, over every head
    return total


def batch_flops(config: dict, B: int) -> int:
    """One identify batch: the model once on the (B, T) queries: the hooked
    convolutions and FFN linears, plus the attention's projections and
    products."""
    s = config["audfprint"]
    C, spec, temp = transformer_tokens(config, B)
    return (I.forward_flops(config, (B, config["query_seconds"] * s["samplerate"]))
            + attention_flops(C, spec, temp, int(config["model_args"].get("t_layers", 5)), B))


def tf32() -> contextlib.AbstractContextManager:
    """The control: the reference's own strict-float32 switches let TF32
    through, cuDNN's (the convolutions) and cuBLAS's (the Transformer's
    matmuls and the attention's products)."""
    from portbench.ref.models import htdemucs as RH

    switches = RH.tf32_switches
    return mock.patch.object(RH, "tf32_switches", lambda _allow: switches(True))


def near_identity(state: Dict[str, torch.Tensor], args: dict) -> None:
    """The temporal encoder 0 and the outermost temporal decoder carry the
    (normalised) waveform by a perfect-reconstruction pair at stride ``S``
    and kernel ``2 S``, as ``kinds/demucs.py``'s: tap ``t`` of the analysis
    is its own channel pair (+ and -, whose GELUs differ by the tap's
    value), weighted by the sine window ``w``, ``w[t]^2 + w[t + S]^2 = 1``;
    the GLU gates on those channels are held open, the decoder's rewrite
    passes them by its centre tap, and its transposed convolution sums the
    taps back with ``w``. Those two layers (their ``DConv`` too) carry the
    rest of :func:`inputs.weights` at :data:`inputs.PERTURBATION`.

    The deep temporal path (encoders 1 on, the Transformer, the other
    decoders) and the whole spectral branch keep the full scale of
    :func:`inputs.weights`, the spectral branch's outermost transposed
    convolution at :data:`SPECTRAL_OUT` of it, so that the two deep paths
    together add about a tenth of the output. The Transformer's LayerScale
    gammas and packed ``in_proj_weight`` are drawn as biases (0.1 z) and
    kept so: each layer's attention and FFN move its tokens by some
    percent, far above float32's resolution in the output."""
    K, S = int(args.get("kernel_size", 8)), int(args.get("stride", 4))
    H = int(args.get("channels", 48))
    depth = int(args.get("depth", 4))
    if K != 2 * S or H < 2 * K:
        raise ValueError(f"no near-identity HTDemucs for kernel {K}, stride {S}, channels {H}")
    last = f"tdecoder.{depth - 1}."
    for k, v in state.items():
        if k.startswith(("tencoder.0.", last)):
            v.mul_(I.PERTURBATION)
    spec_out = f"decoder.{depth - 1}.conv_tr."
    state[spec_out + "weight"].mul_(SPECTRAL_OUT)
    state[spec_out + "bias"].mul_(SPECTRAL_OUT)
    dev = state["tencoder.0.conv.weight"].device
    t = torch.arange(K, device=dev)
    w = torch.sin(torch.pi * (t + 0.5) / K)
    enc, glu = state["tencoder.0.conv.weight"], state["tencoder.0.rewrite.weight"]
    enc[2 * t, 0, t] += w
    enc[2 * t + 1, 0, t] -= w
    glu[t, 2 * t, 0] += 1.0
    glu[t, 2 * t + 1, 0] -= 1.0
    state["tencoder.0.rewrite.bias"][H + t] += GATE_OPEN
    state[last + "rewrite.weight"][t, t, 1] += 1.0
    state[last + "rewrite.bias"][H + t] += GATE_OPEN
    state[last + "conv_tr.weight"][t, 0, t] += w

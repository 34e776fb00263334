"""The HTDemucs kind (``kinds/htdemucs.py``): one identify batch's FLOPs
against a count by hand of every convolution, linear layer, projection and
attention product, at the CPU tests' sizes and at the published widths; the
identify cell's near-identity weights, and their draw pinned as the cell's
limits were set on it; the configuration file's cut and assumptions; the
TF32 control's switches."""

from __future__ import annotations

import pytest
import torch

from portbench import harness as H
from portbench import inputs as I

CONFIG = H.read_json("portbench/configs/htdemucs48.json")
# sha256 of ``inputs.weights`` and ``inputs.denoiser_weights`` at seed
# 3000000001 on the CPU (``test_portbench_pinned.digest``)
DIGESTS = ("40feb0f11516b5b572b931f8c1182dc9647fdb1ab58a759c62b0076f5435afd4",
           "2ab3c7ac03bee6b6189bd8e70d9dba2e70b804c81e66cc5acea829dec8f54932")


def htdemucs_by_hand(args: dict, B: int, N: int) -> int:
    """2 x multiply-adds of one forward on (B, N) mono waveforms, N a
    multiple of the strides: each branch's encoders (the strided
    convolution, the ``DConv``'s two layers, the 1x1 rewrite to twice the
    channels), the Transformer (in-, out-projections, Q K^T, A V and the
    FFN a layer and branch) and the decoders (the rewrite of kernel 3, 3 x 3
    on the spectral branch, and the transposed convolution)."""
    C0, g, D = args["channels"], args.get("growth", 2), args["depth"]
    nfft, K, S = args["nfft"], 8, 4
    L, heads_dim = args["t_layers"], args.get("t_hidden_scale", 4.0)
    frames = -(-N // (nfft // 4))
    widths = [int(C0 * g ** i) for i in range(D)]
    total = 0

    def dconv(C, positions):
        h = C // 8
        return 2 * (2 * positions * h * C * 3 + 2 * positions * 2 * C * h)

    fr, length = nfft // 2, N
    for i, C in enumerate(widths):
        cin_f, cin_t = (2, 1) if i == 0 else (widths[i - 1], widths[i - 1])
        fr, length = fr // S, length // S
        for cin, positions in ((cin_f, fr * frames), (cin_t, length)):
            total += 2 * B * positions * C * cin * K  # strided convolution
            total += B * dconv(C, positions)
            total += 2 * B * positions * 2 * C * C  # rewrite 1x1
    d = widths[-1]
    spec, temp = fr * frames, length
    for idx in range(L):
        for q, kv in ((spec, temp), (temp, spec)):
            kv = q if idx % 2 == 0 else kv
            total += 2 * B * (q * d * d + kv * 2 * d * d + q * d * d)  # Q, K V, out
            total += 2 * 2 * B * q * kv * d  # Q K^T and A V
            total += 2 * 2 * B * q * d * int(d * heads_dim)  # the FFN's two linears
    for i in reversed(range(D)):
        C = widths[i]
        cout_f, cout_t = (2, 1) if i == 0 else (widths[i - 1], widths[i - 1])
        for taps, cout, positions in ((9, cout_f, fr * frames), (3, cout_t, length)):
            total += 2 * B * positions * 2 * C * C * taps  # rewrite
            total += 2 * B * positions * C * cout * K  # transposed convolution
        fr, length = fr * S, length * S
    return total


def _config(model_args: dict) -> dict:
    cfg = dict(CONFIG)
    cfg["model_args"] = dict(model_args)
    return cfg


@pytest.mark.parametrize("sizes", ["tiny", "published"])
def test_batch_flops_by_hand(sizes):
    kind = I.kind(CONFIG)
    args = dict(CONFIG["model_args"], **(kind.TINY_ARGS if sizes == "tiny" else {}))
    B, N = 128, CONFIG["query_seconds"] * CONFIG["audfprint"]["samplerate"]
    flops = kind.batch_flops(_config(args), B)
    assert flops == htdemucs_by_hand(args, B, N)
    if sizes == "published":
        assert flops == 4_658_794_070_016  # ~4.7 TFLOP a batch of 128 8 s queries
        assert kind.transformer_tokens(_config(args), B) == (384, 504, 250)


def test_weight_draws_are_pinned():
    from portbench.tests.test_portbench_pinned import SEED, digest

    assert digest(I.weights(CONFIG, SEED, "cpu")) == DIGESTS[0]
    assert digest(I.denoiser_weights(CONFIG, SEED, "cpu")) == DIGESTS[1]


def test_near_identity_keeps_the_input_and_its_deep_paths_show():
    """At the CPU tests' sizes on 8 s waveforms: the output is the input
    changed by some percent on every seed; dropping the spectral branch's
    output, or the Transformer's cross-attention, still moves it."""
    from portbench.judge import identify as J
    from portbench.ref.models import htdemucs as RH

    kind = I.kind(CONFIG)
    cfg = _config(dict(CONFIG["model_args"], **kind.TINY_ARGS))
    gen = torch.Generator().manual_seed(0)
    x = 0.3 * torch.randn(2, 64000, generator=gen)
    for seed in (1, 2, 3):
        w = I.denoiser_weights(cfg, seed, "cpu")
        y = J.reference_denoiser(cfg, "cpu", w)[1](x)
        assert 0.0 < float((y - x).norm() / x.norm()) < 0.2
        w[f"decoder.{cfg['model_args']['depth'] - 1}.conv_tr.weight"].zero_()
        w[f"decoder.{cfg['model_args']['depth'] - 1}.conv_tr.bias"].zero_()
        spec_off = J.reference_denoiser(cfg, "cpu", w)[1](x)
        assert float((spec_off - y).abs().max() / y.abs().max()) > 1e-3
    orig = RH.CrossTransformerEncoderLayer.forward
    try:
        RH.CrossTransformerEncoderLayer.forward = (
            lambda self, q, k: self.norm_out(q + self.gamma_2(self._ff_block(self.norm3(q)))))
        w = I.denoiser_weights(cfg, 1, "cpu")
        skipped = J.reference_denoiser(cfg, "cpu", w)[1](x)
    finally:
        RH.CrossTransformerEncoderLayer.forward = orig
    y = J.reference_denoiser(cfg, "cpu", w)[1](x)
    assert float((skipped - y).abs().max() / y.abs().max()) > 1e-3


def test_configuration_states_its_cut():
    """The file's top-level ``sources`` and ``audio_channels`` are the ones
    the model runs with; every key cut or assumed has its published value
    beside it, and every other model argument is the published default."""
    import inspect

    from portbench.ref.models import htdemucs as RH

    m = H.find(H.load_manifest()["configs"], "htdemucs48", "config")
    args = CONFIG["model_args"]
    assert CONFIG["sources"] == args["sources"]
    assert CONFIG["audio_channels"] == args["audio_channels"]
    assert set(m["reduced"]) <= set(CONFIG["published"]) & set(CONFIG["assumed"])
    assert {"samplerate", "segment"} <= set(CONFIG["published"]) & set(CONFIG["assumed"])
    params = inspect.signature(RH.HTDemucs.__init__).parameters
    for key, value in args.items():
        if key in ("sources", "audio_channels", "samplerate", "segment"):
            continue
        published = RH.UNSUPPORTED[key] if key in RH.UNSUPPORTED else params[key].default
        assert value == published, key
    assert CONFIG["precision"] == "float32" and CONFIG["model"] == "htdemucs"


def test_tf32_control_lets_both_switches_through():
    from portbench.ref.models import htdemucs as RH

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = []
    with I.kind(CONFIG).tf32():
        with RH.tf32_switches(False):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
    with RH.tf32_switches(False):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
    assert seen == [(True, True), (False, False)]
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before

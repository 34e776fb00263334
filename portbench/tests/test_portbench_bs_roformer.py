"""The BS-RoFormer kind (``kinds/bs_roformer.py``): one identify batch's
FLOPs against a count by hand of every linear layer and attention product,
at the CPU tests' sizes and at the published widths; the weight draw pinned
as the cell's limits were set on it, the RMSNorm scales drawn without a
fan-in and no RoPE frequency in the state; the identify cell's
near-identity weights; the configuration file's cut and assumptions; the
TF32 control's switches; the reference's imports."""

from __future__ import annotations

import ast
import inspect
import os

import pytest
import torch

from portbench import harness as H
from portbench import inputs as I

CONFIG = H.read_json("portbench/configs/bsroformer384.json")
# sha256 of ``inputs.weights`` and ``inputs.denoiser_weights`` at seed
# 3000000001 on the CPU (``test_portbench_pinned.digest``)
DIGESTS = ("5f47c9b7027f4ff1b6ffc841ef0ceb1cc543f0a756718899dd6daa7b62a07c91",
           "58d590cc9d49b34a2bd3d97df8118e0527397a1cface66fd96165a1d18ddfa5d")


def bs_roformer_by_hand(args: dict, B: int, N: int) -> int:
    """2 x multiply-adds of one forward on (B, N) mono waveforms: the band
    split (2 x bins values a band to ``dim``), each axial block's time and
    band layers (Q, K, V, the out-projection, Q K^T and A V over the axis's
    length, the feed-forward's two linears at 4 x ``dim``) and each band's
    mask MLP (``dim`` to 4 x ``dim`` to twice the band's 2 x bins values)."""
    D, L = args["dim"], args["depth"]
    inner = args.get("heads", 8) * args.get("dim_head", 64)
    bands = args["freqs_per_bands"]
    T, K = 1 + N // args["stft_hop_length"], len(bands)
    tokens = B * T * K
    total = 2 * B * T * D * sum(2 * f for f in bands)  # band split
    for depth, n in ((args["time_transformer_depth"], T), (args["freq_transformer_depth"], K)):
        layer = 2 * tokens * (D * 3 * inner + inner * D + 2 * D * 4 * D) + 2 * 2 * tokens * n * inner
        total += L * depth * layer
    total += sum(2 * B * T * (D * 4 * D + 4 * D * 2 * 2 * f) for f in bands)  # mask MLPs
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
    assert flops == bs_roformer_by_hand(args, B, N)
    if sizes == "published":
        assert flops == 116_898_933_374_976  # ~117 TFLOP a batch of 128 8 s queries


def test_weight_draws_are_pinned_and_fit_the_model():
    """The draw is the pinned one; every RMSNorm ``gamma`` (1-D, under a
    module that is no ``nn.LayerNorm``) is drawn as a bias, not by a
    fan-in, and the state holds no RoPE frequency (they are computed)."""
    from portbench.tests.test_portbench_pinned import SEED, digest

    weights = I.weights(CONFIG, SEED, "cpu")
    assert digest(weights) == DIGESTS[0]
    assert digest(I.denoiser_weights(CONFIG, SEED, "cpu")) == DIGESTS[1]
    kinds = I._kinds(I.reference_model(CONFIG))
    gammas = [k for k in weights if k.endswith(".gamma")]
    assert len(gammas) == 62 + 12 * 2 * 2 + 1  # band split, every layer's two, the last
    assert all(kinds[k] == "bias" and weights[k].dim() == 1 for k in gammas)
    assert not any("rotary" in k or k.endswith("freqs") for k in weights)
    assert sum(v.numel() for v in weights.values()) == CONFIG["parameters"]


def test_near_identity_keeps_the_input_and_its_deep_path_shows(monkeypatch):
    """At the CPU tests' sizes on 8 s waveforms: the output is the input
    moved by some percent on every seed, the mask near 1 + 0j; leaving
    RoPE out, or the axial blocks altogether, still moves it."""
    from portbench.judge import identify as J
    from portbench.ref.models import bs_roformer as RB

    kind = I.kind(CONFIG)
    cfg = _config(dict(CONFIG["model_args"], **kind.TINY_ARGS))
    gen = torch.Generator().manual_seed(0)
    x = 0.3 * torch.randn(2, 64000, generator=gen)
    for seed in (1, 2, 3):
        w = I.denoiser_weights(cfg, seed, "cpu")
        y = J.reference_denoiser(cfg, "cpu", w)[1](x)
        assert 0.02 < float((y - x).norm() / x.norm()) < 0.2
    for owner, name, fake in ((RB, "rope", lambda t: t),
                              (RB.Transformer, "forward", lambda self, t: t)):
        with monkeypatch.context() as m:
            m.setattr(owner, name, fake)
            off = J.reference_denoiser(cfg, "cpu", w)[1](x)
        assert float((off - y).abs().max() / y.abs().max()) > 1e-3, name


def test_configuration_states_its_cut():
    """The top-level ``audio_channels`` is the model's; every key cut or
    assumed has its published value beside it; every other model argument
    is the published default or the paper's value named in ``assumed``; no
    depth is cut."""
    from portbench.ref.models import bs_roformer as RB

    m = H.find(H.load_manifest()["configs"], "bsroformer384", "config")
    args = CONFIG["model_args"]
    assert m["reduced"] == ["tracks", "audio_channels"]
    assert CONFIG["audio_channels"] == 1 and args["stereo"] is False
    assert set(m["reduced"]) <= set(CONFIG["published"]) & set(CONFIG["assumed"])
    assert {"samplerate", "num_stems", "output_gates"} <= set(CONFIG["published"]) & \
        set(CONFIG["assumed"])
    assert (args["dim"], args["depth"], args["heads"], args["dim_head"]) == (384, 12, 8, 64)
    assert (args["stft_n_fft"], args["stft_win_length"], args["stft_hop_length"]) == (2048, 2048, 441)
    assert tuple(args["freqs_per_bands"]) == RB.DEFAULT_FREQS_PER_BANDS
    params = inspect.signature(RB.BSRoformer.__init__).parameters
    # the paper's values where the public code's defaults differ
    paper = {"stft_hop_length": 441, "time_transformer_depth": 1, "freq_transformer_depth": 1}
    for key, value in args.items():
        if key in ("dim", "depth", "freqs_per_bands"):
            continue
        published = paper.get(key, RB.UNSUPPORTED.get(key, params[key].default))
        assert value == published, key
    assert CONFIG["precision"] == "float32" and CONFIG["model"] == "bs_roformer"


def test_tf32_control_lets_both_switches_through():
    from portbench.ref.models import bs_roformer as RB

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = []
    with I.kind(CONFIG).tf32():
        with RB.tf32_switches(False):
            seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
    with RB.tf32_switches(False):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
    assert seen == [(True, True), (False, False)]
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before


def test_reference_imports_only_torch():
    path = os.path.join(H.BENCH_DIR, "ref", "models", "bs_roformer.py")
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "contextlib", "math", "typing", "torch"}

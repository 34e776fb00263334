"""The yardstick's counters against hand counts at small shapes: the UNet's
and Demucs' forward FLOPs (through their kind files), the prunes' bytes and
operations, the roofline's least time, and the statistics of a window."""

from __future__ import annotations

import math

import pytest

from portbench import harness as H
from portbench import inputs as I


def unet_by_hand(N: int, H_: int, W: int, b: int) -> int:
    """2 x multiply-adds of ``UNet(1, 1, base=b)`` on (N, H, W), H and W
    divisible by 16: each 3x3 convolution out_pixels x in x out x 9, each
    2x2 transposed convolution in_pixels x in x out x 4, the 1x1 output."""
    def conv(h, w, cin, cout, taps=9):
        return 2 * N * h * w * cin * cout * taps

    total = conv(H_, W, 1, b) + conv(H_, W, b, b)
    c, h, w = b, H_, W
    for _ in range(4):  # the down path
        h, w = h // 2, w // 2
        total += conv(h, w, c, 2 * c) + conv(h, w, 2 * c, 2 * c)
        c *= 2
    for _ in range(4):  # the up path: transposed conv on the deep input
        total += 2 * N * h * w * c * (c // 2) * 4
        h, w = 2 * h, 2 * w
        total += conv(h, w, c, c // 2) + conv(h, w, c // 2, c // 2)
        c //= 2
    return total + conv(H_, W, b, 1, taps=1)


@pytest.mark.parametrize("base,shape", [(2, (1, 16, 32)), (4, (3, 32, 16))])
def test_unet_flops_by_hand(base, shape):
    cfg = {"model": "unet", "model_args": {"n_channels": 1, "n_classes": 1, "base": base,
                                           "bilinear": False, "rate": 0.0}}
    assert I.forward_flops(cfg, shape) == unet_by_hand(*shape, base)


def test_demucs_lstm_and_convolutions_by_hand():
    # depth 1, no resampling: one encoder and one decoder layer around the LSTM
    cfg = {"model": "demucs", "model_args": {"hidden": 4, "depth": 1, "kernel_size": 8,
                                             "stride": 4, "resample": 1, "causal": True,
                                             "growth": 2, "sample_rate": 8000}}
    B, T = 2, 64
    frames = (T - 8) // 4 + 1  # the valid length is T here: (64 - 8) / 4 + 1 = 15
    enc = 2 * B * frames * 1 * 4 * 8 + 2 * B * frames * 4 * 8 * 1  # conv k8, then 1x1 to 2h (GLU)
    lstm = 2 * 2 * B * frames * 4 * 4 * (4 + 4)  # two layers, one direction (causal)
    dec = 2 * B * frames * 4 * 8 * 1 + 2 * B * frames * 4 * 1 * 8  # 1x1 to 2h, tconv k8
    assert I.forward_flops(cfg, (B, T)) == enc + lstm + dec


def test_prune_work_by_hand():
    (fb, fo), (bb, bo) = I.prune_work(2, 4, 3, fwd_peaks=5, kept_peaks=2)
    cells = 24
    assert fb == cells * 4 + cells + 4 * 4
    assert bb == cells * 4 + 2 * cells + 4 * 4 + 2 * 4
    spread = 2 * 2 * 16
    assert fo == 5 * cells + 4 * 5 + 2 * 4 * 5 + spread
    assert bo == 2 * 4 * 6 + 4 * 5 + 2 * 4 * 2 + spread
    assert I.least_seconds(3.35e12, 1.0, 67e12, 3.35e12) == pytest.approx(1.0)
    assert I.least_seconds(1.0, 67e12, 67e12, 3.35e12) == pytest.approx(1.0)


def test_window_statistics():
    assert H.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    a = H.sub_seeds(2**31 + 7, ["x", "y"])
    assert a == H.sub_seeds(2**31 + 7, ["x", "y"]) and a["x"] != a["y"]
    assert all(0 <= v < 2**31 for v in a.values())


def test_union_and_breakdown():
    trace = {"device": [(0.0, 10.0, "k1"), (5.0, 10.0, "k2"), (30.0, 5.0, "k1")],
             "host": [(14.0, 20.0, "aten::sort"), (20.0, 5.0, "aten::cumsum")]}
    busy, span = H._union(trace["device"])
    assert busy == 20.0 and span == 35.0
    b = H.breakdown(trace)
    assert b["device_ops"][0][0] == "k1" and b["device_ops"][0][1] == pytest.approx(15e-6)
    assert b["idle_gaps"] == [["aten::cumsum", pytest.approx(15e-6)]]
    assert math.isclose(H.device_seconds(trace, lambda n: n == "k1")[0], 15e-6)


@pytest.mark.parametrize("model,shape,deep", [
    ("demucs", (2, 4000), "lstm."),
    ("unet", (2, 33, 40), None),
])
def test_near_identity_denoisers_keep_their_input(model, shape, deep):
    """The identify cells' weights give back the input, changed by some
    percent on every seed; where the kind has a deep path at full scale
    (Demucs: its LSTM), zeroing it still moves the output."""
    import torch

    from portbench.judge import identify as J

    cfg = {"model": model}
    cfg["model_args"] = dict(I.kind(cfg).TINY_ARGS)
    x = torch.rand(shape) if I.kind(cfg).DOMAIN == "spectrogram" else torch.randn(shape)
    for seed in (1, 2, 3):
        w = I.denoiser_weights(cfg, seed, "cpu")
        y = J.reference_denoiser(cfg, "cpu", w)[1](x)
        assert 0.0 < float((y - x).norm() / x.norm()) < 0.2
        if deep:
            for k in w:
                if k.startswith(deep):
                    w[k].zero_()
            moved = J.reference_denoiser(cfg, "cpu", w)[1](x)
            assert float((moved - y).abs().max() / y.abs().max()) > 1e-4


def test_unknown_kind_names_its_missing_file():
    with pytest.raises(SystemExit, match=r"portbench/kinds/nokind\.py"):
        I.kind({"model": "nokind"})


def test_cached_inputs_are_made_once(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(H, "CACHE_DIR", str(tmp_path))
    made = []

    def build():
        made.append(1)
        return {"x": torch.arange(4.0)}

    a = H.cached("thing", {"n": 4}, build, "cpu")
    b = H.cached("thing", {"n": 4}, build, "cpu")
    c = H.cached("thing", {"n": 5}, build, "cpu")
    assert made == [1, 1] and torch.equal(a["x"], b["x"]) and torch.equal(a["x"], c["x"])
    assert len(list(tmp_path.glob("thing-*.pt"))) == 2 and not list(tmp_path.glob("*.part"))

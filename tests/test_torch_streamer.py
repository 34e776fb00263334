"""The port's streaming Demucs (CPU, ``Demucs(hidden=8, depth=4)``).

Against the port's offline forward: a relative L2 delta under 5%, the JAX
package's own limit (the streamer's normalisation is a running estimate).
Against JAX's ``DemucsStreamer`` on the same Flax weights and the same feed:
within 1e-4 of the largest output.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from musicfpaugment_torch.models import Demucs
from musicfpaugment_torch.models import streamer as ts
from musicfpaugment_tpu.models import Demucs as JDemucs
from musicfpaugment_tpu.models.streamer import DemucsStreamer as JDemucsStreamer

from torch_port_helpers import few_threads, flax_demucs_params, port_demucs, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

KW = dict(hidden=8, depth=4, resample=4, sample_rate=8000)


@pytest.fixture(scope="module")
def weights():
    jm = JDemucs(**KW)
    params = flax_demucs_params(jm, length=6000, seed=11)
    return jm, params, port_demucs(params)


def _stream(streamer, x, first=None, step=None):
    """Feed ``x`` (C, T) in chunks (the first ``first`` long, then ``step``),
    then flush; the outputs concatenated as numpy."""
    first = first or streamer.total_length
    step = step or streamer.demucs.total_stride
    outs, pending, size = [], x, first
    while pending.shape[1] > 0:
        outs.append(np.asarray(streamer.feed(pending[:, :size])))
        pending, size = pending[:, size:], step
    outs.append(np.asarray(streamer.flush()))
    return np.concatenate(outs, axis=1)


def _x(samples, seed):
    return np.random.default_rng(seed).standard_normal((1, samples)).astype(np.float32)


def test_streaming_matches_offline(weights):
    model = weights[2]
    x = _x(6000, 0)
    with torch.no_grad():
        offline = model(torch.from_numpy(x)).numpy()
    streamer = ts.DemucsStreamer(model)
    out = _stream(streamer, x)
    assert out.shape[1] >= x.shape[1]
    delta = np.linalg.norm(offline - out[:, : x.shape[1]]) / np.linalg.norm(offline)
    assert delta < 0.05, f"batch/streaming delta {delta:.2%}"
    assert streamer.frames > 0 and streamer.time_per_frame > 0
    streamer.reset_time_per_frame()
    assert streamer.frames == 0 and streamer.time_per_frame == 0


def test_streaming_matches_jax_on_the_same_weights_and_feed(weights):
    jm, params, model = weights
    x = _x(4000, 1)
    want = _stream(JDemucsStreamer(jm, {"params": params}), x)
    got = _stream(ts.DemucsStreamer(model), x)
    assert got.shape == want.shape and got.dtype == np.float32
    assert rel_err(got, want) <= 1e-4


def test_incremental_feed_lengths_equal_one_feed_and_flush(weights):
    model = weights[2]
    x = _x(3000, 2)
    whole = ts.DemucsStreamer(model)
    one = np.concatenate([np.asarray(whole.feed(x)), np.asarray(whole.flush())], axis=1)
    parts = ts.DemucsStreamer(model)
    outs = [np.asarray(parts.feed(torch.from_numpy(c))) for c in np.array_split(x, 7, axis=1)]
    outs.append(np.asarray(parts.flush()))
    got = np.concatenate(outs, axis=1)
    assert got.shape[1] == one.shape[1] >= 3000
    assert rel_err(got, one) <= 1e-6


def test_dry_mix_and_argument_checks(weights):
    model = weights[2]
    x = _x(2000, 3)
    dry = ts.DemucsStreamer(model, dry=1.0)
    out = np.asarray(dry.feed(x))
    np.testing.assert_allclose(out, x[:, : out.shape[1]], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="two dimensional"):
        dry.feed(x[0])
    with pytest.raises(ValueError, match="Expected 1 channels"):
        dry.feed(np.zeros((2, 10), np.float32))
    with pytest.raises(ValueError, match="causal"):
        ts.DemucsStreamer(Demucs(hidden=8, depth=2, causal=False))


def test_benchmark_prints_the_reference_fields():
    buf = io.StringIO()
    with redirect_stdout(buf):
        ts._benchmark(["--device", "cpu", "--hidden", "8", "--depth", "4",
                       "--sample_rate", "8000", "--seconds", "1"])
    text = buf.getvalue()
    for field in ("model size:", "delta batch/streaming:", "initial lag:", "time per frame:", "RTF:"):
        assert field in text, text
    delta = float(text.split("delta batch/streaming: ")[1].split("%")[0])
    assert delta < 5.0, text

"""The two configurations' weights and FLOP counts, pinned to what the
benchmark read before the denoiser kinds had files of their own: the
sha256 of ``inputs.weights`` and ``inputs.denoiser_weights`` at the
published widths (seed 3000000001, drawn on the CPU), and the forward
FLOPs of one identify batch on the meta device. A change to the kind files
or to the draw that moves a single bit of them fails here."""

from __future__ import annotations

import hashlib

import pytest

from portbench import harness as H
from portbench import inputs as I

SEED = 3_000_000_001
DIGESTS = {
    "unet64": ("0a1b5e737dc2e736d729ee35c5d7f50a06014db6639271a7a940ba6807e15c97",
               "5dc3338980c58a8cc6591466eebb2e55edd4fe92b5713c7d23966c4cf19e5a3c"),
    "demucs48": ("d2bbf73058ef98d49fe07e619ecbe3fad267215c947e2ce4ffcfe94ddfbaad5b",
                 "b2413d64f91de0c8022d8c61f38a7b5023679dd335458120c464170db040960a"),
}
# forward_flops at (128, 257, 251) (one shift's spectrograms) and at
# (128, 64000) (the waveforms)
FLOPS = {"unet64": ((128, 257, 251), 11954952568832),
         "demucs48": ((128, 64000), 2576503013376)}


def config(name: str) -> dict:
    return H.read_json(f"portbench/configs/{name}.json")


def digest(state) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        v = state[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_weight_draws_are_the_pinned_ones(name):
    weights, denoiser = DIGESTS[name]
    assert digest(I.weights(config(name), SEED, "cpu")) == weights
    assert digest(I.denoiser_weights(config(name), SEED, "cpu")) == denoiser


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flop_counts_are_the_pinned_ones(name):
    cfg = config(name)
    shape, flops = FLOPS[name]
    assert I.forward_flops(cfg, shape) == flops
    # one identify batch of 128: every shift's spectrogram, or the waveforms once
    per_batch = flops * (cfg["audfprint"]["shifts"] if len(shape) == 3 else 1)
    assert I.kind(cfg).batch_flops(cfg, 128) == per_batch

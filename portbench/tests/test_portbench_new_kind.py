"""A third denoiser kind is new files and entries only: a copy of the
benchmark (``portbench/`` and ``BENCHMARK.json``) takes a toy waveform kind
(one strided convolution, a ``GroupNorm``, one functional attention and a
transposed convolution back to the waveform), with its frozen module, a
configuration, limits, a cell, an end-to-end metric and a reader, and runs
the cell through ``run.main`` on the CPU at the small sizes, traced.
``correct`` holds, the run's model FLOPs are the toy's count by hand
(the hooked convolutions and linear layer plus the attention's two
products, which only the kind's ``batch_flops`` counts), and no file that
was in the copy changed; ``BENCHMARK.json`` only gained entries."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import harness as H

KIND = "toywave"
CELL = "toywave8-identify"
CHANNELS, STRIDE, GROUPS = 8, 4, 2

REFERENCE = '''"""A toy waveform denoiser: a strided convolution to frames, a GroupNorm,
self-attention over the frames, a transposed convolution back, added to
the input."""

import torch
import torch.nn.functional as F
from torch import nn


class ToyWave(nn.Module):
    def __init__(self, channels: int, stride: int, groups: int) -> None:
        super().__init__()
        self.enc = nn.Conv1d(1, channels, 2 * stride, stride=stride)
        self.norm = nn.GroupNorm(groups, channels)
        self.qkv = nn.Linear(channels, 3 * channels)
        self.dec = nn.ConvTranspose1d(channels, 1, 2 * stride, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[-1]
        h = self.norm(self.enc(x[:, None])).transpose(1, 2)
        q, k, v = self.qkv(h).chunk(3, dim=-1)
        y = self.dec(F.scaled_dot_product_attention(q, k, v).transpose(1, 2))[:, 0]
        return x + F.pad(y, (0, T - y.shape[-1]))
'''

KIND_FILE = '''"""The toy waveform kind: the frozen module serves as the program's too,
in the program's waveform hook slot."""

import contextlib

import torch

from portbench import inputs as I

DOMAIN = "waveform"
TINY_ARGS = {"channels": %(c)d, "stride": %(s)d, "groups": %(g)d}


def reference_model(args):
    from portbench.ref.models.toywave import ToyWave

    return ToyWave(**args)


def program_model(args):
    return reference_model(args)


def program_arm(model, settings, device):
    from musicfpaugment_torch.afp.audfprint.analyzer import AudfprintPeaks

    model.eval()

    def hook(wave):
        with torch.inference_mode():
            return model(wave).to(torch.float32)

    return AudfprintPeaks(settings, denoising=True, denoising_model="demucs",
                          wave_denoiser=hook, device=device)


def batch_flops(config, B):
    args = config["model_args"]
    T = config["query_seconds"] * config["audfprint"]["samplerate"]
    frames = (T - 2 * args["stride"]) // args["stride"] + 1
    attention = 2 * 2 * B * frames * frames * args["channels"]  # QK^T and AV
    return I.forward_flops(config, (B, T)) + attention


@contextlib.contextmanager
def tf32():
    from portbench.ref import device as D

    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with D.cudnn_tf32(True):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def near_identity(state, args):
    for v in state.values():
        if v.is_floating_point():
            v.mul_(I.PERTURBATION)
''' % {"c": CHANNELS, "s": STRIDE, "g": GROUPS}

READER = '''def read(run):
    return run.layer.get("model_flops") or None
'''

# the run, in a process of its own whose ``portbench`` is the copy's
RUNNER = '''import json, sys, torch
import portbench
assert portbench.__file__.startswith(sys.argv[1]), portbench.__file__
from portbench.tests import tiny
torch.set_num_threads(2)
rc, line, err = tiny.run_cell(sys.argv[2], trace=1)
print(err[-3000:], file=sys.stderr)
print(json.dumps({"rc": rc, "line": line}))
'''


def file_hashes(root: str) -> dict:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def write_new(root: str, rel: str, text: str) -> None:
    path = os.path.join(root, rel)
    assert not os.path.exists(path), rel
    with open(path, "w") as f:
        f.write(text)


def add_toy(root: str) -> None:
    """The toy kind's files and entries, as a later PR would add them."""
    base = H.read_json("portbench/configs/demucs48.json")
    cfg = dict(base, name="toywave8", model=KIND, source="a toy for the tests",
               model_args={"channels": CHANNELS, "stride": STRIDE, "groups": GROUPS})
    cfg.pop("assumed", None)
    write_new(root, f"portbench/kinds/{KIND}.py", KIND_FILE)
    write_new(root, f"portbench/ref/models/{KIND}.py", REFERENCE)
    write_new(root, "portbench/configs/toywave8.json", json.dumps(cfg, indent=2))
    write_new(root, f"portbench/limits/{CELL}.json",
              json.dumps(H.read_json("portbench/limits/demucs48-identify.json")))
    write_new(root, "portbench/metrics/model_flops.identify_toywave.py", READER)
    path = os.path.join(root, "BENCHMARK.json")
    m = H.load_manifest(path)
    m["configs"].append({"name": "toywave8", "source": "https://example.org/toywave",
                         "file": "portbench/configs/toywave8.json", "reduced": [],
                         "why": "a toy waveform kind with a norm leaf and functional attention"})
    m["workloads"].append({"name": CELL, "config": "toywave8", "traffic": "identify", "chips": 1,
                           "why": "the identify queries with the toy before the second arm"})
    m["end_to_end"].append({"name": "identify_qps.toywave", "unit": "queries/s",
                            "better": "higher", "bound": 0.05, "source": "host_clock",
                            "workloads": [CELL]})
    m["per_layer"].append({"name": "model_flops.identify_toywave", "unit": "FLOP",
                           "better": "lower", "source": "host_clock", "layer": "denoiser",
                           "moves": "identify_qps.toywave", "workloads": [CELL]})
    with open(path, "w") as f:
        json.dump(m, f, indent=2)


def toy_batch_flops_by_hand(B: int, T: int) -> int:
    frames = (T - 2 * STRIDE) // STRIDE + 1
    conv = 2 * B * frames * 1 * CHANNELS * 2 * STRIDE
    linear = 2 * B * frames * CHANNELS * 3 * CHANNELS
    attention = 2 * B * frames * frames * CHANNELS * 2
    tconv = 2 * B * CHANNELS * frames * 1 * 2 * STRIDE
    return conv + linear + attention + tconv


def test_a_third_kind_is_new_files_and_entries(tmp_path):
    root = str(tmp_path / "checkout")
    shutil.copytree(H.BENCH_DIR, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(H.MANIFEST, os.path.join(root, "BENCHMARK.json"))
    bench_before = file_hashes(os.path.join(root, "portbench"))
    manifest_before = H.load_manifest(os.path.join(root, "BENCHMARK.json"))
    add_toy(root)

    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1",
               PYTHONPATH=os.pathsep.join([root, H.REPO]))
    out = subprocess.run([sys.executable, "-c", RUNNER, root, CELL], cwd=root, env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    line = res["line"]
    assert res["rc"] == 0 and line is not None, out.stderr[-3000:]
    assert line["correct"] is True, out.stderr[-3000:]
    assert line["failed"] == 0 and "den_rel.denoised" in line["checks"]

    # the window's FLOPs are its batches' at the toy's count by hand
    from portbench.tests import tiny

    B = tiny.IDENTIFY["traffic"]["batch"]
    cfg = H.read_json("portbench/configs/demucs48.json")
    T = cfg["query_seconds"] * cfg["audfprint"]["samplerate"]
    batches = line["attempted"] // B
    assert line["metrics"]["model_flops.identify_toywave"]["value"] == \
        batches * toy_batch_flops_by_hand(B, T)

    # nothing that was there changed; the manifest only gained entries
    after = file_hashes(os.path.join(root, "portbench"))
    assert {k: after.get(k) for k in bench_before} == bench_before
    manifest_after = H.load_manifest(os.path.join(root, "BENCHMARK.json"))
    for key, value in manifest_before.items():
        if isinstance(value, list):
            assert manifest_after[key][: len(value)] == value, key
        else:
            assert manifest_after[key] == value, key

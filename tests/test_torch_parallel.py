"""The port's parallel layer (CPU): the mesh helpers against the JAX
package's, ``ShardedAugmenter`` over ``["cpu", "cpu"]`` equal to ``apply`` on
the whole batch, both matchers with ``mesh=["cpu", "cpu"]`` bit-identical to
one device and equal to JAX's 8-device CPU mesh (the corpus of
tests/test_matcher_mesh.py), a 2-rank gloo DDP UNet step in float64 equal
to the single-process step on the global batch within 1e-10 (and a step
with per-rank BatchNorm statistics that is not), and the train CLI's
``--multihost`` at world size 1 on gloo.

Every process group lives in a subprocess with a hard timeout.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.afp.dejavu import DejavuDeviceIndex, DejavuDeviceMatcher
from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.parallel import (
    DATA_AXIS,
    ShardedAugmenter,
    batch_sharding,
    init_multihost,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from musicfpaugment_tpu.afp.audfprint import AudfprintPeaks as JAudfprintPeaks
from musicfpaugment_tpu.afp.audfprint import DeviceMatcher as JDeviceMatcher
from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
from musicfpaugment_tpu.afp.dejavu.matcher_device import DejavuDeviceIndex as JDejavuDeviceIndex
from musicfpaugment_tpu.afp.dejavu.matcher_device import DejavuDeviceMatcher as JDejavuDeviceMatcher
from musicfpaugment_tpu.parallel import make_mesh as j_make_mesh
from musicfpaugment_tpu.parallel import shard_batch as j_shard_batch

from torch_ddp_worker import step as ddp_step
from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_ddp_worker.py")
TIMEOUT_S = 120
SR = 8000
PARAMS = {"density": 20, "pks-per-frame": 5, "freq-sd": 30, "shifts": 1,
          "samplerate": 8000, "n_fft": 512, "n_hop": 256}


@pytest.fixture
def one_thread():
    """The CPU's FFTs and grouped convolutions give every example the same
    bits whatever the batch only with one thread (and batches of 8)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_mesh_helpers_match_jax():
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh == [torch.device("cpu")] * 2 and DATA_AXIS == "data"
    assert make_mesh(1, devices=["cpu", "cpu"]) == [torch.device("cpu")]
    tree = {"x": np.arange(24, dtype=np.float32).reshape(8, 3), "y": (torch.arange(8),)}
    sharded = shard_batch(tree, mesh)
    assert [tuple(t.shape) for t in sharded["x"]] == [(4, 3), (4, 3)]
    j_sharded = j_shard_batch(tree["x"], j_make_mesh(2))
    np.testing.assert_array_equal(torch.cat(sharded["x"]).numpy(), np.asarray(j_sharded))
    assert torch.equal(torch.cat(sharded["y"][0]), tree["y"][0])
    rep = replicate({"w": torch.ones(3)}, mesh)["w"]
    assert len(rep) == 2 and rep[0] is rep[1]  # one copy a distinct device
    assert batch_sharding(mesh).split and not replicated(mesh).split
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        shard_batch(np.zeros((3, 2)), mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPU mesh"):
            make_mesh()


def test_init_multihost_needs_an_address(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_multihost(device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        init_multihost("tcp://127.0.0.1:1", device="cpu")


def test_sharded_augmenter_equals_apply_on_the_whole_batch(one_thread):
    nb, ib = synthetic_banks(sample_rate=SR, noise_row_length=SR, device="cpu")
    fp = AugmentFP(nb, SR, impulse_response_dir=ib, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((16, 1, SR)).astype(np.float32))
    sa = ShardedAugmenter(fp, ["cpu", "cpu"])
    assert sa.num_devices == 2
    shards = sa.batch_augment(x, key=prng.key(4))
    assert [tuple(s.shape) for s in shards] == [(8, 1, SR)] * 2
    whole = fp.apply(x, fp.draw(16, SR, prng.key(4)))
    assert torch.equal(torch.cat(shards), whole)
    with pytest.raises(ValueError, match="not divisible"):
        sa.batch_augment(x[:3])
    coupled = AugmentFP(nb, SR, impulse_response_dir=ib, device="cpu", batch_quantile_clipping=True)
    with pytest.raises(ValueError, match="cannot be split"):
        ShardedAugmenter(coupled, ["cpu"])


def _tone_track(rng, seconds):
    """tests/test_matcher_mesh.py's tracks."""
    t = np.arange(seconds * SR)
    x = np.zeros(len(t), np.float32)
    for _ in range(40):
        f = rng.uniform(100, 3500)
        start = int(rng.integers(0, len(t) - SR // 4))
        dur = int(rng.integers(SR // 16, SR // 4))
        end = min(start + dur, len(t))
        seg = np.arange(end - start)
        env = np.exp(-8.0 * seg / SR).astype(np.float32)
        x[start:end] += np.sin(2 * np.pi * f * seg / SR).astype(np.float32) * env * rng.uniform(0.3, 1.0)
    x += 0.005 * rng.standard_normal(len(t)).astype(np.float32)
    return x / np.abs(x).max()


@pytest.fixture(scope="module")
def corpus():
    r = np.random.default_rng(17)
    tracks = np.stack([_tone_track(r, seconds=4) for _ in range(6)])
    queries = []
    for qi in range(16):  # divisible by the 8-device mesh
        tid = qi % len(tracks)
        start = int(r.integers(0, tracks.shape[1] - 2 * SR))
        queries.append(tracks[tid, start : start + 2 * SR])
    return tracks, np.stack(queries)


def test_audfprint_mesh_is_bit_identical(corpus, one_thread):
    tracks, queries = corpus
    names = [f"track_{i}" for i in range(len(tracks))]
    ht, j_ht = HashTable(), JHashTable()
    AudfprintPeaks(PARAMS, device="cpu").ingest_batch(ht, names, tracks)
    JAudfprintPeaks(PARAMS).ingest_batch(j_ht, names, tracks)
    single = DeviceMatcher(ht, device="cpu").match_waveforms(queries, shifts=4)
    meshed = DeviceMatcher(ht, mesh=["cpu", "cpu"])
    assert meshed.device == torch.device("cpu") and list(meshed._replicas) == [torch.device("cpu")]
    assert meshed.match_waveforms(queries, shifts=4) == single
    four = DeviceMatcher(ht, mesh=["cpu"] * 4).match_waveforms(queries, shifts=4)
    assert four == single
    assert sum(v == "MATCH" for v, _, _ in single) >= len(queries) - 2
    j_sharded = JDeviceMatcher(j_ht, mesh=j_make_mesh(8)).match_waveforms(queries, shifts=4)
    assert [tuple(v) for v in j_sharded] == single
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        DeviceMatcher(ht, mesh=["cpu"] * 3).match_waveforms(queries)


def test_dejavu_mesh_is_bit_identical(corpus, one_thread):
    tracks, queries = corpus
    names = [f"track_{i}" for i in range(len(tracks))]
    idx, j_idx = DejavuDeviceIndex(), JDejavuDeviceIndex()
    idx.ingest_arrays(names, tracks, device="cpu")
    j_idx.ingest_arrays(names, tracks)
    single = DejavuDeviceMatcher(idx, device="cpu").match_waveforms(queries)
    meshed = DejavuDeviceMatcher(idx, mesh=["cpu", "cpu"]).match_waveforms(queries)
    assert meshed == single and sum(bool(r) for r in single) >= len(queries) - 2
    j_sharded = JDejavuDeviceMatcher(j_idx, mesh=j_make_mesh(8)).match_waveforms(queries)
    assert j_sharded == single


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(world: int, rank: int, port: int) -> dict:
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank), OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


def _run_all(cmds_envs) -> list:
    """Start every (command, env) at once, wait for all within TIMEOUT_S,
    kill the rest on a timeout or a failure."""
    procs = [subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for cmd, env in cmds_envs]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


@pytest.fixture(scope="module")
def ddp_two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp")
    port = _free_port()
    _run_all([([sys.executable, WORKER, str(out)], _env(2, r, port)) for r in (0, 1)])
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    return ranks, ddp_step(str(tmp_path_factory.mktemp("single")))


def test_two_rank_ddp_step_equals_the_global_batch_step(ddp_two_ranks):
    ranks, single = ddp_two_ranks
    assert all(r["world"] == 2 and r["global_bn"]["ddp"] == "DistributedDataParallel" for r in ranks)
    assert single["ddp"] == "UNet"
    runs = [r["global_bn"] for r in ranks]
    # the global loss is the mean of the ranks' (equal slices)
    assert abs(np.mean([r["loss"] for r in runs]) - single["loss"]) <= 1e-10 * single["loss"]
    for run in runs:
        for k, g in single["grads"].items():
            assert _rel(run["grads"][k], g) <= 1e-10, k
        for k, v in single["state"].items():
            if v.is_floating_point():  # parameters after the Adam step, running statistics
                assert _rel(run["state"][k], v) <= 1e-10, k
            else:
                assert torch.equal(run["state"][k], v), k
        for k, v in single["val"].items():
            assert abs(run["val"][k] - v) <= 1e-10 * abs(v), k
        assert abs(run["metrics"]["psnr"] - single["metrics"]["psnr"]) <= 1e-10 * abs(single["metrics"]["psnr"])


def test_per_rank_batchnorm_statistics_would_differ(ddp_two_ranks):
    """The same two ranks with each BatchNorm on its own slice: the step is
    another function (what nn.BatchNorm2d under DDP computes)."""
    ranks, single = ddp_two_ranks
    worst = max(_rel(r["rank_bn"]["grads"][k], g) for r in ranks for k, g in single["grads"].items())
    assert worst > 1e-3
    stats = [k for k in single["state"] if "running_var" in k]
    assert max(_rel(ranks[0]["rank_bn"]["state"][k], single["state"][k]) for k in stats) > 1e-6


def test_train_cli_multihost_world_one_on_gloo(tmp_path):
    code = (
        "import json, sys; from musicfpaugment_torch.train import train; "
        "t = train.main(sys.argv[1:]); "
        "print(json.dumps({'history': t.history, 'ddp': type(t._train_model).__name__}))"
    )
    argv = ["--multihost", "--device", "cpu", "--base", "4", "--epochs", "2", "--train-steps", "1",
            "--val-steps", "1", "--batch-size", "4"]
    (out,) = _run_all([([sys.executable, "-c", code, *argv], _env(1, 0, _free_port()))])
    assert "multihost: process 0 joined the group" in out
    result = json.loads(out.strip().splitlines()[-1])
    assert result["ddp"] == "DistributedDataParallel"
    assert [h["epoch"] for h in result["history"]] == [1]
    assert np.isfinite(result["history"][0]["val"]["loss"])

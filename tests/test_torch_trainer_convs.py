"""cuDNN's flags around the trainer's convolutions: the step's forward and
backward, validation and the media triplet run under
``device.cudnn_measured`` (TF32 off, engines chosen by timing); the
augmenter's filter convolutions and the models called on their own keep
cuDNN's heuristic; every flag is restored, also after a step that
raises; ``trainer.tuned_shapes`` counts the steps of a shape not met
before. The spies record the flags the convolutions see (on the CPU the
flags are set and read as on the card; cuDNN does not run).

The ``cuda``-marked test runs three steps at the UNet's published width on
the card under the measured scope, under the heuristic and under TF32. The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_trainer_convs.py --noconftest -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
from musicfpaugment_torch.core import filters as tfilt
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.device import MEASURED_ENGINES
from musicfpaugment_torch.models import Demucs, UNet
from musicfpaugment_torch.train import trainer as ttrainer
from musicfpaugment_torch.train.trainer import Trainer
from musicfpaugment_torch.utils import profiling

from torch_threads import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
BATCH = 4
CONVS = (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Conv1d, torch.nn.ConvTranspose1d)


def _flags():
    c = torch.backends.cudnn
    return (c.enabled, c.benchmark, c.deterministic, c.allow_tf32)


def _spy_convs(model, seen):
    """Record the flags at each convolution's forward and backward."""
    def record(*_):
        c = torch.backends.cudnn
        seen.append((c.allow_tf32, c.benchmark))

    n = 0
    for m in model.modules():
        if isinstance(m, CONVS):
            m.register_forward_hook(record)
            m.register_full_backward_hook(record)
            n += 1
    return n


def _trainer(tmp_path, augmenter=True, **kw):
    fp = None
    if augmenter:
        noise_bank, ir_bank = synthetic_banks(SR, num_noise=4, num_irs=2, noise_row_length=SR,
                                              device="cpu")
        fp = AugmentFP(noise_bank, SR, impulse_response_dir=ir_bank, device="cpu")
    torch.manual_seed(0)
    return Trainer(UNet(1, 1, rate=0.0, base=4), synthetic_clean_batches(BATCH, SR, SR, seed=7),
                   1, synthetic_clean_batches(BATCH, SR, SR, seed=8), 1, 1e-3, 2, str(tmp_path),
                   input_type="spec", augmenter=fp, device="cpu", **kw)


@pytest.mark.filterwarnings("ignore:Full backward hook is firing")
def test_step_convolutions_are_measured_and_filters_keep_the_heuristic(tmp_path, monkeypatch):
    """In ``train_step`` the UNet's convolutions, forward and backward, see
    TF32 off and ``benchmark`` on; the augmenter's direct filter
    convolutions in the same step see ``benchmark`` off."""
    trainer = _trainer(tmp_path)
    seen, filt = [], []
    n = _spy_convs(trainer.model, seen)
    conv1d = tfilt.F.conv1d

    def spy(*args, **kwargs):
        filt.append((torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark))
        return conv1d(*args, **kwargs)

    monkeypatch.setattr(tfilt.F, "conv1d", spy)
    before = _flags()
    assert before == (True, False, False, True)  # PyTorch's defaults
    trainer.train_step(*trainer._get_batch(trainer.train_iter))
    assert n == 23 and len(seen) == 2 * n
    assert set(seen) == {(False, True)}
    assert filt and set(filt) == {(False, False)}
    assert _flags() == before


def test_validation_and_media_triplet_are_measured(tmp_path):
    trainer = _trainer(tmp_path)
    seen = []
    n = _spy_convs(trainer.model, seen)
    trainer.validation_epoch()
    clean, aug = next(iter(trainer._val_batches()))
    trainer._media_triplet(clean, aug)
    assert len(seen) == 2 * n and set(seen) == {(False, True)}
    assert _flags() == (True, False, False, True)


@pytest.mark.parametrize("kind", ["unet", "demucs"])
def test_models_outside_the_trainer_keep_the_heuristic(kind):
    """``UNet.forward`` and ``Demucs.forward`` called on their own (not
    through an identify hook, which times its engines:
    ``tests/test_torch_identify_convs.py``) see TF32 off and ``benchmark``
    off."""
    torch.manual_seed(0)
    if kind == "unet":
        model, x = UNet(1, 1, base=4), torch.rand(2, 33, 16)
    else:
        model, x = Demucs(hidden=4, depth=2), torch.randn(2, 1, 2000)
    seen = []
    assert _spy_convs(model, seen)
    with torch.no_grad():
        model(x)
    assert seen and set(seen) == {(False, False)}
    assert _flags() == (True, False, False, True)


@pytest.mark.parametrize("before", [(True, False, False, True), (True, True, True, False)],
                         ids=["defaults", "set"])
def test_flags_are_restored_after_a_step_and_after_one_that_raises(tmp_path, monkeypatch, before):
    trainer = _trainer(tmp_path, augmenter=False)
    clean = next(synthetic_clean_batches(BATCH, SR, SR, seed=3))
    c = torch.backends.cudnn
    enabled, benchmark, deterministic, allow_tf32 = before
    with c.flags(enabled=enabled, benchmark=benchmark, deterministic=deterministic,
                 allow_tf32=allow_tf32):
        trainer.train_step(clean, 0.5 * clean)
        assert _flags() == before

        def boom(*_):
            assert (c.allow_tf32, c.benchmark) == (False, True)
            raise RuntimeError("loss")

        monkeypatch.setattr(ttrainer, "l1_loss", boom)
        with pytest.raises(RuntimeError, match="loss"):
            trainer.train_step(clean, 0.5 * clean)
        assert _flags() == before
    assert _flags() == (True, False, False, True)


def test_tuned_shapes_counts_the_steps_of_a_new_clip_length(tmp_path):
    trainer = _trainer(tmp_path, augmenter=False)
    batches = synthetic_clean_batches(BATCH, SR, SR, seed=3)
    one_s, half_s = next(batches), next(batches)[:, : SR // 2]
    counted = []
    profiling.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for clean in (one_s, one_s, half_s, one_s, half_s):
                before = profiling.counters().get("trainer.tuned_shapes", 0)
                trainer.train_step(clean, 0.5 * clean)
                counted.append(profiling.counters().get("trainer.tuned_shapes", 0) - before)
    finally:
        profiling.reset()
    assert counted == [1, 0, 1, 0, 0]


# ------------------------------------------------------------ on the card

CARD_STEPS = 3
CARD_LOSS_STEP1 = 2e-6  # portbench/limits/unet64-train.json's loss.step1


def _card_losses(route):
    """Three steps of the UNet at its published width, batch 128 of 3 s
    clips (128 x 257 x 94 spectrograms), dropout 0.05, from one seed's
    weights, batches and keys; the step's convolutions under ``route``:
    ``measured`` (the trainer's own), ``heuristic`` (TF32 off, cuDNN's
    heuristic) or ``tf32`` (TF32 allowed forward and backward). Returns the
    losses and the (TF32, ``benchmark``, ``benchmark_limit``) flags the
    convolutions saw."""
    from musicfpaugment_torch import device as D
    from musicfpaugment_torch.models import unet as U

    if route == "heuristic":
        ttrainer.cudnn_measured = lambda: D.cudnn_tf32(False, benchmark=False)
    elif route == "tf32":
        ttrainer.cudnn_measured = lambda: D.cudnn_tf32(True, benchmark=False)
        U.cudnn_tf32 = lambda allow: D.cudnn_tf32(True)
    torch.manual_seed(11)
    trainer = Trainer(UNet(1, 1, rate=0.05), iter(()), 1, iter(()), 1, 1e-3, 1,
                      os.path.join(os.environ["CARD_CKPT"], route), input_type="spec",
                      device="cuda", seed=20)
    seen = set()

    def record(*_):
        c = torch.backends.cudnn
        seen.add((c.allow_tf32, c.benchmark, c.benchmark_limit))

    for m in trainer.model.modules():
        if isinstance(m, CONVS):
            m.register_forward_hook(record)
    rng = np.random.default_rng(20)
    losses = []
    for clean in synthetic_clean_batches(128, 3 * SR, SR, seed=20):
        aug = (0.7 * clean + 0.2 * rng.standard_normal(clean.shape)).astype(np.float32)
        losses.append(float(trainer.train_step(clean, aug)["loss"]))
        if len(losses) == CARD_STEPS:
            return {"losses": losses, "flags": sorted(seen)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: cuDNN's engines run on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_measured_steps_on_card_agree_with_the_heuristic_and_not_with_tf32(cuda_device, tmp_path):
    """Each route in a process of its own (cuDNN keeps one engine a
    convolution problem a process, whichever route chose it). The measured
    route's first loss is within the benchmark's ``loss.step1`` limit of the
    heuristic's; TF32's is not, so TF32 stays off in the measured route."""
    out = {}
    for route in ("measured", "heuristic", "tf32"):
        code = ("import json, sys; sys.path.insert(0, 'tests'); "
                "import test_torch_trainer_convs as t; "
                f"print(json.dumps(t._card_losses({route!r})))")
        run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env={**os.environ, "CARD_CKPT": str(tmp_path)}, timeout=600,
                             cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert run.returncode == 0, run.stderr[-4000:]
        out[route] = json.loads(run.stdout.strip().splitlines()[-1])
    m, h, t = (out[r]["losses"] for r in ("measured", "heuristic", "tf32"))
    assert out["measured"]["flags"] == [[False, True, MEASURED_ENGINES]], out
    assert out["heuristic"]["flags"] == [[False, False, 10]], out
    assert all(np.isfinite(m)) and len(m) == CARD_STEPS
    assert abs(m[0] - h[0]) <= CARD_LOSS_STEP1 * abs(h[0]), out
    assert abs(t[0] - h[0]) > CARD_LOSS_STEP1 * abs(h[0]), out

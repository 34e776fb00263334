"""Training extras, port against the JAX package (CPU): the CQT and its
losses within 1e-5, ``visualisation.spectrogram`` and its plot,
``utils.config.parse_into``, the monitoring callbacks (the JAX package's
``tf.summary`` calls recorded through a stand-in ``tensorflow`` module
against the port's writer calls: the same arrays in the same layouts; the
port's through a real ``SummaryWriter`` read back from its event files), the
trainer's ``_log_media`` and ``_log_tensorboard`` at ``base=8`` and the
``generate_audios`` demo on the CPU.
"""

import dataclasses
import os
import sys
import types
from contextlib import contextmanager

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
from musicfpaugment_torch.models import Demucs, UNet
from musicfpaugment_torch.train import callbacks as tcb
from musicfpaugment_torch.train import cqt as tcqt
from musicfpaugment_torch.train import generate_audios as tgen_audio
from musicfpaugment_torch.train import visualisation as tvis
from musicfpaugment_torch.train.trainer import Trainer, spectrogram_batch
from musicfpaugment_torch.utils import TrainConfig, parse_into
from musicfpaugment_tpu.train import callbacks as jcb
from musicfpaugment_tpu.train import cqt as jcqt
from musicfpaugment_tpu.train import visualisation as jvis
from musicfpaugment_tpu.utils import TrainConfig as JTrainConfig
from musicfpaugment_tpu.utils import parse_into as jparse_into

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000


def _waves(batch, seconds, seed):
    return np.random.default_rng(seed).standard_normal((batch, int(seconds * SR))).astype(np.float32) * 0.3


def _forever(make):
    while True:
        yield make()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("bpo,hop", [(48, 512), (36, 128), (24, 64)])
def test_cqt_magnitude_matches_jax(bpo, hop):
    x = _waves(2, 1.5, 3)  # shorter than the longest kernel: the pad reflects twice
    got = tcqt.cqt_magnitude(torch.from_numpy(x), bins_per_octave=bpo, hop_length=hop).numpy()
    want = np.asarray(jcqt.cqt_magnitude(jnp.asarray(x), bins_per_octave=bpo, hop_length=hop))
    assert got.shape == want.shape and got.shape[1] > 100
    assert _rel(got, want) <= 1e-5
    assert got.min() >= 1e-7


def test_cqt_losses_match_jax():
    x, y = _waves(2, 3, 4), _waves(2, 3, 5)
    y = x + 0.3 * y
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for got, want in (
        (tcqt.cqt_loss(tx, ty, 32.70, 4186.009, 36, 128),
         jcqt.cqt_loss(jnp.asarray(x), jnp.asarray(y), 32.70, 4186.009, 36, 128)),
        (tcqt.multi_resolution_cqt_loss(tx, ty), jcqt.multi_resolution_cqt_loss(jnp.asarray(x), jnp.asarray(y))),
    ):
        for g, w in zip(got, want):
            assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w)) and float(w) > 0
    with pytest.raises(ValueError, match="resolutions"):
        tcqt.multi_resolution_cqt_loss(tx, ty, f_min=(32.7,))
    # gradients flow (the loss is differentiable)
    tx.requires_grad_(True)
    sum(tcqt.multi_resolution_cqt_loss(tx, ty)).backward()
    assert torch.isfinite(tx.grad).all() and tx.grad.abs().max() > 0


def test_visualisation_spectrogram_matches_jax(tmp_path):
    x = _waves(2, 1, 6)
    got = tvis.spectrogram(torch.from_numpy(x)).numpy()
    want = np.asarray(jvis.spectrogram(x))
    assert got.shape == want.shape == (2, 257, 32) and _rel(got, want) <= 1e-5
    one = tvis.spectrogram(x[0])
    assert tuple(one.shape) == (257, 32)
    db, j_db = tvis.spectrogram(x[0], amplitude=True), jvis.spectrogram(x[0], amplitude=True)
    loud = j_db > -60
    assert db.max() == 0.0 and np.abs(db[loud] - j_db[loud]).max() < 1e-3
    fig = tvis.plot_spectrogram(one, str(tmp_path / "s.png"), amplitude=True)
    assert os.path.getsize(tmp_path / "s.png") > 1000 and fig.axes[0].get_title() == "STFT spectrum"


@dataclasses.dataclass
class _Flags:
    name: str = "x"
    steps: int = 3
    rate: float = 0.5
    on: bool = False


@pytest.mark.parametrize("argv", [[], ["--batch-size", "4", "--learning-rate", "0.01", "--model", "demucs"],
                                  ["--seed", "7", "--unknown", "1"]])
def test_parse_into_matches_jax(argv):
    got, want = parse_into(TrainConfig, argv), jparse_into(JTrainConfig, argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    flags = ["--name", "y", "--steps", "9", "--rate", "0.25", "--on", "yes"]
    assert parse_into(_Flags, flags) == _Flags("y", 9, 0.25, True) == jparse_into(_Flags, flags)


class RecordingWriter:
    """The three ``SummaryWriter`` calls the callbacks make, recorded."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, value, step))

    def add_audio(self, tag, clip, step, sample_rate):
        self.calls.append(("audio", tag, np.array(clip), step, sample_rate))

    def add_image(self, tag, img, step, dataformats):
        self.calls.append(("image", tag, np.array(img), step, dataformats))


@pytest.fixture
def fake_tf(monkeypatch):
    """A stand-in ``tensorflow`` whose ``tf.summary`` calls are recorded."""
    calls = []
    summary = types.SimpleNamespace(
        scalar=lambda tag, value, step: calls.append(("scalar", tag, value, step)),
        audio=lambda tag, data, sr, step, max_outputs: calls.append(("audio", tag, np.array(data), step, sr)),
        image=lambda tag, data, step, max_outputs: calls.append(("image", tag, np.array(data), step)),
    )
    monkeypatch.setitem(sys.modules, "tensorflow", types.SimpleNamespace(summary=summary))

    class Writer:
        @contextmanager
        def as_default(self):
            yield

    return calls, Writer()


def test_callbacks_pass_jax_layouts(fake_tf):
    calls, j_writer = fake_tf
    w = RecordingWriter()
    clean, aug, den = _waves(4, 1, 7), _waves(4, 1, 8), _waves(4, 1, 9)
    tcb.monitor_losses(w, {"loss": 0.5, "l1": np.float32(0.25)}, "train", 3)
    jcb.monitor_losses(j_writer, {"loss": 0.5, "l1": np.float32(0.25)}, "train", 3)
    tcb.monitor_metrics(w, {"psnr": 20.0}, "val", 3)
    jcb.monitor_metrics(j_writer, {"psnr": 20.0}, "val", 3)
    assert [c for c in w.calls] == [c for c in calls] and len(calls) == 3
    w.calls.clear()
    calls.clear()
    tcb.monitor_audios(w, torch.from_numpy(clean), aug, den, 10, "val")
    jcb.monitor_audios(j_writer, clean, aug, den, 10, "val")
    assert [c[1] for c in calls] == ["val/clean", "val/augmented", "val/denoised"]
    for name, (_, _, j_audio, step, sr) in zip(("clean", "augmented", "denoised"), calls):
        mine = [c for c in w.calls if c[1].startswith(f"val/{name}/")]
        assert [c[1] for c in mine] == [f"val/{name}/{i}" for i in range(3)]
        assert all(c[3] == step == 10 and c[4] == sr == SR for c in mine)
        np.testing.assert_array_equal(np.stack([c[2] for c in mine]), j_audio)  # (3, T, 1)
    for precomputed in (True, False):
        w.calls.clear()
        calls.clear()
        if precomputed:
            specs = [np.abs(_waves(4, 1, s)).reshape(4, 100, 80) for s in (1, 2, 3)]
            tcb.monitor_specs_precomputed(w, *specs, epoch=20, datas="val")
            jcb.monitor_specs_precomputed(j_writer, *specs, epoch=20, datas="val")
        else:
            tcb.monitor_specs(w, clean, aug, den, 20, "val")
            jcb.monitor_specs(j_writer, clean, aug, den, 20, "val")
        for name, (_, tag, j_img, step) in zip(("clean", "augmented", "denoised"), calls):
            mine = [c for c in w.calls if c[1].startswith(f"val/spec_{name}/")]
            assert tag == f"val/spec_{name}" and len(mine) == 3
            assert all(c[3] == step == 20 and c[4] == "HWC" for c in mine)
            got = np.stack([c[2] for c in mine])  # (3, H, W, 1), flipped, max 1
            assert got.shape == j_img.shape and np.isclose(got.max(), 1.0)
            if precomputed:
                np.testing.assert_array_equal(got, j_img)
            else:
                assert np.abs(got - j_img).max() <= 1e-5


def test_callbacks_write_event_files(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    from torch.utils.tensorboard import SummaryWriter

    writer = SummaryWriter(str(tmp_path))
    clean, aug, den = _waves(3, 0.5, 1), _waves(3, 0.5, 2), _waves(3, 0.5, 3)
    tcb.monitor_losses(writer, {"loss": 0.5}, "train", 1)
    tcb.monitor_audios(writer, clean, aug, den, 1, "val")
    tcb.monitor_specs(writer, clean, aug, den, 1, "val")
    writer.close()
    events = EventAccumulator(str(tmp_path), size_guidance={"images": 0, "audio": 0})
    events.Reload()
    tags = events.Tags()
    assert tags["scalars"] == ["train/loss"] and events.Scalars("train/loss")[0].value == 0.5
    assert sorted(tags["audio"]) == sorted(f"val/{n}/{i}" for n in ("clean", "augmented", "denoised")
                                           for i in range(3))
    assert len(tags["images"]) == 9 and events.Images("val/spec_clean/0")[0].height == 257


@pytest.fixture
def spec_trainer(tmp_path):
    torch.manual_seed(0)
    nb, ib = synthetic_banks(sample_rate=SR, noise_row_length=SR, device="cpu")
    fp = AugmentFP(nb, SR, impulse_response_dir=ib, device="cpu")
    batches = _forever(lambda: _waves(4, 1, 11))
    return Trainer(UNet(1, 1, rate=0.0, base=8), batches, 1, batches, 1, 1e-3, 3, str(tmp_path),
                   input_type="spec", augmenter=fp, monitoring=True, device="cpu",
                   writer=RecordingWriter())


def test_log_media_spec_at_base_8(spec_trainer):
    spec_trainer._log_media(10)
    calls = spec_trainer.writer.calls
    assert [c[0] for c in calls] == ["image"] * 9
    clean, aug = next(iter(spec_trainer._val_batches()))
    spec_trainer.model.eval()
    with torch.no_grad():
        den = spec_trainer.model(spectrogram_batch(aug))
    for name, spec in (("clean", spectrogram_batch(clean)), ("augmented", spectrogram_batch(aug)),
                       ("denoised", den)):
        mine = np.stack([c[2] for c in calls if c[1].startswith(f"val/spec_{name}/")])
        want = spec[:3].numpy()[..., None]
        want = (want / want.max())[:, ::-1]
        assert mine.shape == (3, 257, 32, 1) and np.isfinite(mine).all()
        assert np.abs(mine - want).max() <= 1e-6


def test_log_media_audio_and_scalars(tmp_path):
    torch.manual_seed(1)
    batches = _forever(lambda: (_waves(4, 1, 12), _waves(4, 1, 13)))
    writer = RecordingWriter()
    tt = Trainer(Demucs(hidden=4, depth=2), batches, 1, batches, 1, 5e-4, 3, str(tmp_path),
                 input_type="audio", monitoring=True, device="cpu", writer=writer)
    tt._log_media(10)
    assert sum(c[0] == "audio" for c in writer.calls) == 9
    assert sum(c[0] == "image" for c in writer.calls) == 9
    assert all(c[2].shape == (SR, 1) for c in writer.calls if c[0] == "audio")
    writer.calls.clear()
    tt.training_loop()  # epochs 1 and 2: scalars each epoch, no media (epoch % 10)
    scalars = [(c[1], c[3]) for c in writer.calls]
    assert all(c[0] == "scalar" for c in writer.calls)
    for epoch in (1, 2):
        for tag in ("train/loss", "train/l1_loss", "val/loss", "val/psnr"):
            assert (tag, epoch) in scalars
    assert [h["epoch"] for h in tt.history] == [1, 2]


def test_monitoring_without_a_writer_uses_summary_writer(tmp_path):
    batches = _forever(lambda: (_waves(2, 1, 14), _waves(2, 1, 15)))
    tt = Trainer(UNet(1, 1, rate=0.0, base=4), batches, 1, batches, 1, 1e-3, 2, str(tmp_path),
                 input_type="spec", monitoring=True, device="cpu")
    tt.training_loop()
    files = os.listdir(tmp_path / "tb")
    assert any(f.startswith("events.out.tfevents") for f in files)
    tt.writer.close()


@pytest.mark.parametrize("model", ["unet", "demucs"])
def test_generate_audios_on_the_cpu(model, tmp_path):
    ckpt = tmp_path / "ckpt"
    base = ["--model", model, "--device", "cpu", "--seconds", "1", "--seed", "3"]
    random_out = tgen_audio.main(base + ["--out", str(tmp_path / "random"), "--checkpoint", str(ckpt)])
    names = {os.path.basename(p) for p in random_out}
    wavs = {"clean.wav", "augmented.wav"} | ({"denoised.wav"} if model == "demucs" else set())
    assert names == wavs | {"clean.png", "augmented.png", "denoised.png"}
    assert all(os.path.getsize(p) > 1000 for p in random_out)
    # a checkpoint in the trainer's format is loaded
    torch.manual_seed(99)
    net = UNet(1, 1, rate=0.05) if model == "unet" else Demucs()
    os.makedirs(ckpt / "best_epoch")
    torch.save({"model": net.state_dict()}, ckpt / "best_epoch" / "state.pt")
    out_a = tgen_audio.main(base + ["--out", str(tmp_path / "a"), "--checkpoint", str(ckpt)])
    out_b = tgen_audio.main(base + ["--out", str(tmp_path / "b"), "--checkpoint", str(ckpt)])
    for a, b, r in zip(out_a, out_b, random_out):
        if a.endswith(".wav"):
            assert open(a, "rb").read() == open(b, "rb").read()
            if "denoised" in a:
                assert open(a, "rb").read() != open(r, "rb").read()
            else:  # clean and augmented do not depend on the model
                assert open(a, "rb").read() == open(r, "rb").read()

"""The port on the card: its CUDA kernels against their plain PyTorch
versions, and the UNet, the denoiser hook, the metrics, a training step,
Demucs, its streamer and the sinc resampler against the CPU; Dejavu; the
last slice: both matchers and the sharded augmenter on a [cuda, cuda] mesh
against one card, the CQT against the CPU, a world-1 NCCL DDP step against
the plain step, the trainer's media logging and the demo app.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The kernels must agree with the plain prunes bit for bit (same IEEE
operations, see csrc/peaks_prune.cu). From waveforms, cuFFT and the CPU's
FFT round differently at ~1e-6, which can flip a near-tie cell: >= 0.999 of
cells must agree there, and verdicts must be equal.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from musicfpaugment_torch import convert
from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.afp.audfprint import peaks as tp
from musicfpaugment_torch.afp.audfprint import peaks_cuda
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.models import UNet
from musicfpaugment_torch.testing import metrics as tmetrics
from musicfpaugment_torch.testing.parameters import afp_settings

A_DEC = tp.prune_decay(20.0, 256)
FROM_WAVEFORM_AGREEMENT = 0.999


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA prune kernels have no CPU mode")
    return torch.device("cuda")


def _logsg(seed, B, F, C):
    x = gaussian_filter(
        np.random.default_rng(seed).standard_normal((B, F, C)), sigma=(0, 2.0, 1.5)
    ).astype(np.float32) * 3
    return x - x.mean(axis=(1, 2), keepdims=True)


def _valid_frames(kind, B, C, device):
    """Per-row column counts: None, the mixed ingest lengths, the edge counts
    (0, 1 and C among them), or a stacked batch's C and C - 1."""
    if kind is None:
        return None
    if kind == "mixed":
        vals = [700, 513, 626, 90]
    elif kind == "edge":
        vals = [(0, 1, C, C // 2, C - 1, 2)[i % 6] for i in range(B)]
    else:  # "stacked": shift 0 has one column more than the other shifts
        vals = [C if i < B // 4 else C - 1 for i in range(B)]
    return torch.tensor(vals, dtype=torch.int32, device=device)


KERNEL_CASES = [
    # B, F, C, valid_frames, quantised
    (8, 256, 251, None, False),
    (4, 256, 700, "mixed", False),
    (3, 96, 40, None, False),
    # few levels: equal values in a column are common (tie order)
    (8, 256, 251, None, True),
    (3, 96, 50, None, True),
    # one column, fewer than the envelope's 10, fewer than the ring's depth
    (4, 256, 1, None, False),
    (4, 256, 7, None, False),
    (4, 256, 3, None, True),
    (6, 256, 3, "edge", False),
    # valid_frames with 0, 1 and C
    (6, 256, 60, "edge", False),
    (12, 256, 251, "edge", True),
    # other widths: one bin per lane, odd bins per lane, 16 bins per lane
    (3, 32, 50, None, True),
    (5, 32, 50, "edge", False),
    (6, 96, 60, "edge", False),
    (2, 512, 40, None, False),
    (6, 512, 40, "edge", True),
    (3, 64, 30, None, False),
    (3, 128, 30, None, True),
    # batch sizes: one row, not a multiple of the warps in a block, many
    (1, 256, 100, None, False),
    (5, 256, 100, "edge", False),
    (512, 256, 30, None, False),
    # the stacked shifts of a match batch: 251 and 250 columns
    (16, 256, 251, "stacked", False),
    (16, 256, 251, "stacked", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,C,valid,quantised", KERNEL_CASES)
def test_cuda_kernels_match_plain(cuda_device, B, F, C, valid, quantised):
    x = _logsg(B + C, B, F, C)
    if quantised:
        x = np.round(x * 2) / 2
    x = torch.from_numpy(x).to(cuda_device)
    vf = _valid_frames(valid, B, C, cuda_device)
    if vf is not None:
        x = torch.where(tp._col_mask(x.shape, vf), x, -1e30).contiguous()
    fk = peaks_cuda.forward_prune_cuda(x, A_DEC)
    fp = tp.forward_prune(x, A_DEC, 30.0, 5)
    assert torch.equal(fk, fp)
    bk = peaks_cuda.backward_prune_cuda(x, fp, A_DEC, 30.0, 5, vf)
    bp = tp.backward_prune(x, fp, A_DEC, 30.0, 5, vf)
    assert torch.equal(bk, bp)
    if C >= 10:
        assert fp.any() and bp.any()
    else:
        # the envelope starts from these very columns, so few cells pass the
        # forward test: give the backward pass marked cells of its own
        marked = torch.from_numpy(
            np.random.default_rng(C).random((B, F, C)) < 0.02
        ).to(cuda_device)
        want = tp.backward_prune(x, marked, A_DEC, 30.0, 5, vf)
        got = peaks_cuda.backward_prune_cuda(x, marked, A_DEC, 30.0, 5, vf)
        assert torch.equal(got, want) and want.any()
    # the time-major functions the path calls, the backward one on the
    # forward kernel's own bytes
    tm = x.transpose(1, 2).contiguous()
    f_tm = peaks_cuda.forward_prune_tm(tm, A_DEC)
    b_tm = peaks_cuda.backward_prune_tm(tm, f_tm, A_DEC, 30.0, 5, vf)
    assert f_tm.dtype == b_tm.dtype == torch.uint8 and int(b_tm.max()) <= 1
    assert torch.equal(peaks_cuda.as_bool_masks(f_tm), fp)
    assert torch.equal(peaks_cuda.as_bool_masks(b_tm), bp)


@pytest.mark.cuda
@pytest.mark.parametrize("F,maxpks", [(256, 5), (256, 2), (96, 5), (512, 3)])
def test_cuda_backward_takes_any_mask(cuda_device, F, maxpks):
    """More marked cells per column than rounds, on quantised values: the
    kernel re-tests the ``maxpks`` largest, lowest bin first among equals."""
    B, C = 4, 40
    x = torch.from_numpy(np.round(_logsg(F, B, F, C) * 2) / 2).to(cuda_device)
    marked = torch.from_numpy(np.random.default_rng(F).random((B, F, C)) < 0.08).to(cuda_device)
    assert int(marked.sum(dim=1).max()) > maxpks
    got = peaks_cuda.backward_prune_cuda(x, marked, A_DEC, 30.0, maxpks)
    want = tp.backward_prune(x, marked, A_DEC, 30.0, maxpks)
    assert torch.equal(got, want) and want.any()
    fk = peaks_cuda.forward_prune_cuda(x, A_DEC, 30.0, maxpks)
    assert torch.equal(fk, tp.forward_prune(x, A_DEC, 30.0, maxpks))


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_shapes(cuda_device):
    with pytest.raises(ValueError):
        peaks_cuda.forward_prune_cuda(torch.zeros((1, 100, 8), device=cuda_device), A_DEC)
    with pytest.raises(ValueError):
        peaks_cuda.forward_prune_cuda(torch.zeros((1, 544, 8), device=cuda_device), A_DEC)
    with pytest.raises(ValueError):
        peaks_cuda.forward_prune_cuda(
            torch.zeros((1, 256, 8), device=cuda_device, dtype=torch.float64), A_DEC
        )
    tm = torch.zeros((2, 8, 256), device=cuda_device)
    with pytest.raises(ValueError):  # not contiguous
        peaks_cuda.forward_prune_tm(tm.transpose(0, 1), A_DEC)
    with pytest.raises(ValueError):  # bool, not the kernels' 0/1 bytes
        peaks_cuda.backward_prune_tm(tm, tm.bool(), A_DEC)
    with pytest.raises(ValueError):  # a CPU tensor never reaches a kernel
        peaks_cuda.forward_prune_tm(tm.cpu(), A_DEC)


@pytest.mark.cuda
def test_find_peaks_batch_on_card_launches_kernels(cuda_device):
    x = np.random.default_rng(4).standard_normal((3, 3 * 8000)).astype(np.float32)
    peaks_cuda.reset_launch_counts()
    got = tp.find_peaks_batch(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    assert peaks_cuda.LAUNCHES == {"forward_prune": 1, "backward_prune": 1}
    want = tp.find_peaks_batch(torch.from_numpy(x)).numpy()
    assert (got == want).mean() >= FROM_WAVEFORM_AGREEMENT


@pytest.mark.cuda
@pytest.mark.parametrize("shifts", [1, 4])
def test_shifts_on_card_take_one_launch_pair(cuda_device, shifts):
    x = torch.from_numpy(
        np.random.default_rng(7).standard_normal((3, 40 * 256)).astype(np.float32)
    ).to(cuda_device)
    peaks_cuda.reset_launch_counts()
    got = tp.find_peaks_shifts(x, shifts)
    assert peaks_cuda.LAUNCHES == {"forward_prune": 1, "backward_prune": 1}
    assert [int(g.shape[-1]) for g in got] == [41] + [40] * (shifts - 1)
    for s, g in enumerate(got):  # equal to each shift pruned on its own
        off = int(s / shifts * 256)
        assert torch.equal(g, tp.find_peaks_batch(x[:, off:])) and g.any()


@pytest.mark.cuda
def test_match_waveforms_card_equals_cpu(cuda_device):
    tracks = next(synthetic_clean_batches(6, 12 * 8000, seed=3))
    names = [f"w{i}" for i in range(6)]
    crops = np.stack([tracks[i % 6, 8000 : 8000 + 8 * 8000] for i in range(8)])
    verdicts = []
    for dev in (cuda_device, torch.device("cpu")):
        ht = HashTable(depth=20)
        AudfprintPeaks(afp_settings["audfprint"], device=dev).ingest_batch(ht, names, tracks)
        verdicts.append(DeviceMatcher(ht, device=dev).match_waveforms(crops, shifts=2))
    assert [v[:2] for v in verdicts[0]] == [v[:2] for v in verdicts[1]]
    assert [v[1] for v in verdicts[0]] == [names[i % 6] for i in range(8)]


# ------------------------------------------------------------ augmentation


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [{}, {"fuse_lti": False}, {"fast_chain": False}])
@pytest.mark.parametrize("condition", ["default_parameters", "bn_0", "reverb", "recording_device"])
def test_augment_chain_on_card_matches_cpu(cuda_device, condition, mode):
    """The same draws through the chain on the card and on the CPU: cuFFT
    and cuDNN against the CPU's libraries, TF32 off, on outputs whose peak
    is 1 (1e-5: float32 rounding reads about 1e-6, a clipping threshold
    moves with the rounding before it, and TF32 would read about 1e-3)."""
    from musicfpaugment_torch import augment
    from musicfpaugment_torch.testing.parameters import test_pipelines_parameters

    banks = augment.synthetic_banks(num_noise=8, num_irs=4, seed=1, device="cpu")
    params = test_pipelines_parameters[condition]
    on_cpu = augment.AugmentFP(
        banks[0], 8000, parameters=params, impulse_response_dir=banks[1], device="cpu", **mode)
    on_card = augment.AugmentFP(
        banks[0], 8000, parameters=params, impulse_response_dir=banks[1],
        device=cuda_device, **mode)
    x = next(synthetic_clean_batches(16, 8 * 8000, seed=5))[:, None, :]
    x[3] = 0.0
    on_cpu.freeze_parameters(42)
    draws = on_cpu.draw_indexed(range(16), 8 * 8000, prng.key(42))
    want = on_cpu.apply(x, draws)
    got = on_card.apply(x, draws)
    assert got.device.type == "cuda" and got.shape == want.shape
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    on_card.freeze_parameters(42)
    assert torch.equal(on_card.batch_augment_indexed(x, range(16)), got)
    # the card's own arithmetic does not depend on the batch size
    halves = torch.cat([on_card.apply(x[:8], [{k: v[:8] for k, v in d.items()} for d in draws]),
                        on_card.apply(x[8:], [{k: v[8:] for k, v in d.items()} for d in draws])])
    assert float((halves - got).abs().max()) <= 1e-6


def _seeded_unet(seed, **kwargs):
    """A UNet at base=16 on the CPU with fan-in-scaled kernels and
    BatchNorm statistics that are not trivial, from a torch seed."""
    g = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng():
        torch.manual_seed(seed)  # the layers' own initial kernels
        model = UNet(1, 1, base=16, **kwargs)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(0.8 + 0.4 * torch.rand(m.weight.shape, generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return model.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("bilinear", [False, True])
def test_unet_on_card_matches_cpu(cuda_device, bilinear):
    """Strict float32 on the card against the CPU: 1e-4 of the largest
    output (TF32 would read about 1e-3); bfloat16 compute within 5e-2."""
    on_cpu = _seeded_unet(1, bilinear=bilinear)
    x = torch.rand((3, 257, 94), generator=torch.Generator().manual_seed(2))
    want = convert.unet_denoiser(on_cpu)(x)
    on_card = _seeded_unet(1, bilinear=bilinear).to(cuda_device)
    got = convert.unet_denoiser(on_card)(x.to(cuda_device))
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == x.shape
    top = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * top
    half = _seeded_unet(1, bilinear=bilinear, dtype=torch.bfloat16).to(cuda_device)
    low = convert.unet_denoiser(half)(x.to(cuda_device))
    assert low.dtype == torch.float32
    assert float((low.cpu() - want).abs().max()) <= 5e-2 * top
    # the strict forward leaves the process's TF32 setting as it found it
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled


@pytest.mark.cuda
def test_denoiser_hook_on_card_matches_cpu_route(cuda_device):
    x = next(synthetic_clean_batches(4, 24000, seed=61, sample_rate=8000))
    on_cpu = _seeded_unet(3)
    t_cpu = convert.unet_denoiser(on_cpu)
    t_card = convert.unet_denoiser(_seeded_unet(3).to(cuda_device))
    # let the untrained network move every bin by up to 20%
    hook_cpu = lambda s: s * (1.0 + 0.2 * torch.tanh(t_cpu(s)))
    hook_card = lambda s: s * (1.0 + 0.2 * torch.tanh(t_card(s)))
    sg_cpu = tp.spectrogram_frontend(torch.from_numpy(x), denoiser=hook_cpu)
    sg_card = tp.spectrogram_frontend(torch.from_numpy(x).to(cuda_device), denoiser=hook_card)
    assert float((sg_card.cpu() - sg_cpu).abs().max()) <= 1e-5 * float(sg_cpu.abs().max())
    peaks_cuda.reset_launch_counts()
    got = tp.find_peaks_shifts(torch.from_numpy(x).to(cuda_device), 4, denoiser=hook_card)
    assert peaks_cuda.LAUNCHES == {"forward_prune": 1, "backward_prune": 1}
    want = tp.find_peaks_shifts(torch.from_numpy(x), 4, denoiser=hook_cpu)
    for g, w in zip(got, want):
        assert float((g.cpu() == w).float().mean()) >= FROM_WAVEFORM_AGREEMENT and g.any()
    analyzer = AudfprintPeaks(afp_settings["audfprint"], denoising=True, denoising_model="unet",
                              spec_denoiser=hook_card, device=cuda_device)
    assert torch.equal(analyzer.peaks_batch(x), tp.find_peaks_batch(
        torch.from_numpy(x).to(cuda_device), denoiser=hook_card))


@pytest.mark.cuda
@pytest.mark.parametrize("tolerance", [0, 1])
def test_metrics_on_card_tensors_match_cpu(cuda_device, tolerance):
    r = np.random.default_rng(7)
    gt = r.random((4, 256, 251)) < 0.01
    pred = (gt & (r.random(gt.shape) < 0.5)) | (r.random(gt.shape) < 0.005)
    got = tmetrics.batch_peak_metrics(
        torch.from_numpy(pred).to(cuda_device), torch.from_numpy(gt).to(cuda_device),
        tolerance, reduce=False)
    want = tmetrics.batch_peak_metrics(pred, gt, tolerance, reduce=False)
    for key in ("precision", "recall", "f1"):
        assert got[key].is_cuda
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0, atol=1e-6)
    a = torch.from_numpy(r.random((4, 257, 251)).astype(np.float32))
    b = a + 0.01 * torch.from_numpy(r.standard_normal(a.shape).astype(np.float32))
    torch.testing.assert_close(
        tmetrics.batch_psnr(a.to(cuda_device), b.to(cuda_device)).cpu(), tmetrics.batch_psnr(a, b),
        rtol=0, atol=1e-4)
    assert tmetrics.Recall(tolerance)(torch.from_numpy(pred[:1]).to(cuda_device),
                                      torch.from_numpy(gt[:1]).to(cuda_device)) == pytest.approx(
        tmetrics.Recall(tolerance)(pred[:1], gt[:1]), abs=1e-6)


def _step_trainer(device, tmp_path, dtype=None, train_iter=(), save=False, nb_epochs=2):
    from musicfpaugment_torch.train.trainer import Trainer

    torch.manual_seed(5)
    return Trainer(UNet(1, 1, rate=0.0, base=8, dtype=dtype), iter(train_iter), 1,
                   iter(train_iter), 1, 1e-3, nb_epochs, str(tmp_path), input_type="spec",
                   save=save, device=device)


def _step_batch():
    clean = next(synthetic_clean_batches(8, 24000, seed=67, sample_rate=8000))
    aug = (0.7 * clean + 0.2 * np.random.default_rng(67).standard_normal(clean.shape)).astype(np.float32)
    return clean, aug


@pytest.mark.cuda
@pytest.mark.filterwarnings("ignore:Full backward hook is firing")
def test_train_step_on_card_matches_cpu(cuda_device, tmp_path):
    """One "spec" step, card against CPU from the same weights and batch.
    Strict float32: loss within 1e-5 (relative), running statistics within
    1e-5 of their largest values, every backward convolution with cuDNN on
    and TF32 off. Gradients within 1e-4 of each tensor's largest value in
    float64: in float32 they jump where rounding flips a ReLU or a max-pool
    choice (up to 8e-2 between two float32 runs of this model). A bfloat16
    step is finite and its loss within 5e-2 of the float32 one."""
    clean, aug = _step_batch()
    runs, flags, convs = {}, [], []
    for label, device, dtype, body in (
            ("cpu", "cpu", torch.float32, None), ("card", cuda_device, torch.float32, None),
            ("cpu64", "cpu", torch.float64, None), ("card64", cuda_device, torch.float64, None),
            ("bf16", cuda_device, torch.float32, torch.bfloat16)):
        trainer = _step_trainer(device, tmp_path / label, body)
        trainer.model.to(dtype)
        if label == "card":
            for m in trainer.model.modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                    convs.append(m)
                    m.register_full_backward_hook(lambda *_: flags.append(
                        (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32)))
        terms = trainer.train_step(torch.from_numpy(clean).to(device, dtype),
                                   torch.from_numpy(aug).to(device, dtype))
        runs[label] = (float(terms["loss"]),
                       {k: p.grad.cpu() for k, p in trainer.model.named_parameters()},
                       {k: v.cpu() for k, v in trainer.model.state_dict().items() if "running_" in k})
    (loss_c, _, stats_c), (loss_g, _, stats_g) = runs["cpu"], runs["card"]
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for k, want in stats_c.items():
        assert float((stats_g[k] - want).abs().max()) <= 1e-5 * float(want.abs().max()), k
    assert len(flags) == len(convs) == 23 and set(flags) == {(True, False)}
    grads_c64, grads_g64 = runs["cpu64"][1], runs["card64"][1]
    for k, want in grads_c64.items():
        assert float((grads_g64[k] - want).abs().max()) <= 1e-4 * float(want.abs().max()), k
    loss_b, grads_b, _ = runs["bf16"]
    assert np.isfinite(loss_b) and all(bool(torch.isfinite(g).all()) for g in grads_b.values())
    assert abs(loss_b - loss_c) <= 5e-2 * abs(loss_c)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cudnn.enabled


@pytest.mark.cuda
def test_save_and_resume_on_card(cuda_device, tmp_path):
    import json

    from musicfpaugment_torch.augment import AugmentFP, synthetic_banks

    batches = [next(synthetic_clean_batches(4, 8000, seed=70 + i, sample_rate=8000)) for i in range(4)]
    noise_bank, ir_bank = synthetic_banks(8000, num_noise=4, num_irs=2, noise_row_length=8000,
                                          device=cuda_device)
    fp = AugmentFP(noise_bank, 8000, impulse_response_dir=ir_bank, device=cuda_device)

    def make(nb_epochs, train_iter):
        from musicfpaugment_torch.train.trainer import Trainer

        torch.manual_seed(5)
        return Trainer(UNet(1, 1, rate=0.0, base=8), train_iter, 2, iter(batches * 4), 1, 1e-3,
                       nb_epochs, str(tmp_path / "ckpt"), input_type="spec", augmenter=fp,
                       save=True, device=cuda_device)

    train_iter = iter(batches * 4)
    first = make(2, train_iter)
    first.training_loop()
    meta = json.loads((tmp_path / "ckpt" / "last_epoch" / "trainer_meta.json").read_text())
    assert set(meta) == {"epoch", "best_val_loss", "scheduler", "early_stopping"}
    resumed = make(2, train_iter)
    assert resumed.epoch_start == 1 and resumed.step == 2
    assert resumed.scheduler.state_dict() == first.scheduler.state_dict()
    for k, v in first.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    assert next(resumed.model.parameters()).is_cuda
    resumed.training_loop()
    assert resumed.step == 4 and np.isfinite(resumed.history[-1]["val"]["loss"])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_demucs_on_card_matches_cpu(cuda_device, causal):
    """Strict float32 within 1e-4 of the largest output (float32 rounding
    through cuDNN's convolutions and LSTM), bfloat16 within 5e-2; every
    milestone of the same shape on both."""
    from musicfpaugment_torch.models import Demucs, rescale_params

    torch.manual_seed(3)
    cpu = rescale_params(Demucs(hidden=8, depth=3, causal=causal), 0.1).eval()
    card = Demucs(hidden=8, depth=3, causal=causal).to(cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    bf16 = Demucs(hidden=8, depth=3, causal=causal, dtype=torch.bfloat16).to(cuda_device).eval()
    bf16.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(next(synthetic_clean_batches(3, 20000, 8000, seed=5)))
    with torch.no_grad():
        want = cpu(x)
        top = float(want.abs().max())
        assert float((card(x.to(cuda_device)).cpu() - want).abs().max()) <= 1e-4 * top
        assert float((bf16(x.to(cuda_device)).cpu() - want).abs().max()) <= 5e-2 * top
        for stop in ("frontend", "enc1", "enc", "lstm", "dec"):
            assert card(x.to(cuda_device), stop_at=stop).shape == cpu(x, stop_at=stop).shape


@pytest.mark.cuda
def test_streamer_and_resampler_on_card_match_cpu(cuda_device):
    from musicfpaugment_torch.core import resample
    from musicfpaugment_torch.models import Demucs
    from musicfpaugment_torch.models.streamer import DemucsStreamer

    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 3001)).astype(np.float32))
    for fn in (resample.upsample2, resample.downsample2, lambda t: resample.resample_frac(t, 8000, 16000)):
        want = fn(x)
        assert float((fn(x.to(cuda_device)).cpu() - want).abs().max()) <= 1e-6 * float(want.abs().max())
    torch.manual_seed(4)
    model = Demucs(hidden=8, depth=4).eval()
    outs = {}
    for dev in ("cpu", cuda_device):
        streamer = DemucsStreamer(model.to(dev))
        parts = [streamer.feed(c) for c in np.array_split(x[:1].numpy(), 5, axis=1)]
        outs[str(dev)] = torch.cat(parts + [streamer.flush()], dim=1)
        assert outs[str(dev)].device.type == "cpu" and outs[str(dev)].shape[1] >= 3001
    want = outs["cpu"]
    assert float((outs["cuda"] - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ------------------------------------------------------------------ Dejavu


def _dejavu_tracks(n, seconds, seed):
    return next(synthetic_clean_batches(n, seconds * 8000, 8000, seed=seed))


@pytest.mark.cuda
def test_dejavu_masks_and_packing_on_card_match_cpu(cuda_device):
    """Masks from the same log spectrogram and packed hashes from the same
    masks bit-identical; masks from the same waveforms in >= 0.999 of
    cells (cuFFT against the CPU's FFT)."""
    import importlib

    df = importlib.import_module("musicfpaugment_torch.afp.dejavu.fingerprint")
    x = torch.from_numpy(_dejavu_tracks(4, 8, 91)) * 32767.0
    logd, mask, sgram = df.fingerprint_spectrogram_batch(x)
    c_logd, c_mask, c_sgram = df.fingerprint_spectrogram_batch(x.to(cuda_device))
    assert float((c_sgram.cpu() - sgram).abs().max()) <= 1e-5 * float(sgram.abs().max())
    assert (c_mask.cpu() == mask).float().mean() >= FROM_WAVEFORM_AGREEMENT
    assert torch.equal(df.detect_peaks_mask(logd.to(cuda_device)).cpu(), mask)
    plateaus = torch.round(logd / 8) * 8  # equal neighbours in a window
    assert torch.equal(df.detect_peaks_mask(plateaus.to(cuda_device), amp_min=10).cpu(),
                       df.detect_peaks_mask(plateaus, amp_min=10))
    for max_peaks in (64, 1024):
        got = df.pack_hashes_from_masks(mask.to(cuda_device), max_peaks)
        want = df.pack_hashes_from_masks(mask, max_peaks)
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_dejavu_match_on_card_matches_cpu(cuda_device):
    import importlib

    from musicfpaugment_torch.afp.dejavu import DejavuDeviceIndex, DejavuDeviceMatcher

    dm_mod = importlib.import_module("musicfpaugment_torch.afp.dejavu.matcher_device")
    df = importlib.import_module("musicfpaugment_torch.afp.dejavu.fingerprint")
    tracks = _dejavu_tracks(12, 12, 92)
    names = [f"t{i}" for i in range(12)]
    idx, c_idx = DejavuDeviceIndex(), DejavuDeviceIndex()
    idx.ingest_arrays(names, tracks, device="cpu")
    c_idx.ingest_arrays(names, tracks, device=cuda_device)
    for g, w in zip(c_idx.finalize(), idx.finalize()):
        np.testing.assert_array_equal(g, w)
    cpu, card = DejavuDeviceMatcher(idx, device="cpu"), DejavuDeviceMatcher(idx, device=cuda_device)
    queries = np.stack([t[8000 * (1 + i % 3):][: 8 * 8000] for i, t in enumerate(tracks)])
    _, masks, _ = df.fingerprint_spectrogram_batch(torch.from_numpy(queries))
    packed = df.pack_hashes_from_masks(masks, 1024)
    kw = cpu._match_kwargs(cpu._effective_mqf(masks.shape[-1]))
    want = dm_mod._dejavu_match_impl(cpu._starts, cpu._rows, *packed[:4], **kw)
    got = dm_mod._dejavu_match_impl(card._starts, card._rows, *(p.to(cuda_device) for p in packed[:4]), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    c_v, v = card.recognize_waveforms(queries), cpu.recognize_waveforms(queries)
    assert sum(a["results"][0]["song_name"] == b["results"][0]["song_name"]
               for a, b in zip(c_v, v) if a["match"] and b["match"]) >= 11
    assert all(r["match"] and r["results"][0]["song_name"].decode() == n for r, n in zip(c_v, names))


@pytest.mark.cuda
def test_dejavu_ties_on_card(cuda_device):
    """The lower song id, then the lower offset, wins a tie on the card."""
    import importlib

    from musicfpaugment_torch.afp.dejavu import DejavuDeviceIndex, DejavuDeviceMatcher

    dm_mod = importlib.import_module("musicfpaugment_torch.afp.dejavu.matcher_device")
    k1, k2, k3 = (10 << 17) | (20 << 8) | 3, (30 << 17) | (40 << 8) | 5, (50 << 17) | (60 << 8) | 7
    idx = DejavuDeviceIndex()
    for i, hashes in enumerate([[(k1, 10), (k2, 20)], [(k1, 5), (k2, 15)], [(k3, 7), (k3, 9), (k1, 40)]]):
        idx.add_song(f"s{i}", hashes)
    dm = DejavuDeviceMatcher(idx, device=cuda_device)
    keys = torch.tensor([[k1, k2, 1 << 30], [k3, 1 << 30, 1 << 30], [k1, 1 << 30, 1 << 30]],
                        dtype=torch.int32, device=cuda_device)
    t1 = torch.tensor([[0, 10, 0], [0, 0, 0], [3, 0, 0]], dtype=torch.int32, device=cuda_device)
    valid = keys < (1 << 30)
    out = dm_mod._dejavu_match_impl(dm._starts, dm._rows, keys, t1, valid, valid,
                                    **dm._match_kwargs(dm._effective_mqf(16)))
    assert [o.tolist() for o in out] == [[0, 2, 0], [2, 1, 1], [10, 7, 7], [2, 2, 1]]


# ------------------------------------------------------------ the last slice


def _mesh_corpus(n_tracks=8, seconds=12, n_queries=16, seed=93):
    from musicfpaugment_torch.data.synthetic import synth_tracks_device

    tracks = synth_tracks_device(seed, range(n_tracks), seconds * 8000, 8000, device="cpu").numpy()
    r = np.random.default_rng(seed)
    starts = r.integers(0, (seconds - 8) * 8000, n_queries)
    queries = np.stack([tracks[i % n_tracks, s : s + 8 * 8000] for i, s in enumerate(starts)])
    return tracks, queries


@pytest.mark.cuda
def test_mesh_matchers_on_card_equal_one_card(cuda_device):
    """Both matchers with mesh=[cuda, cuda]: every verdict equal to the one-card call."""
    from musicfpaugment_torch.afp.dejavu import DejavuDeviceIndex, DejavuDeviceMatcher

    tracks, queries = _mesh_corpus()
    names = [f"t{i}" for i in range(len(tracks))]
    ht = HashTable()
    AudfprintPeaks(afp_settings["audfprint"], device=cuda_device).ingest_batch(ht, names, tracks)
    mesh = [cuda_device, cuda_device]
    single = DeviceMatcher(ht, device=cuda_device).match_waveforms(queries, shifts=4)
    meshed = DeviceMatcher(ht, mesh=mesh)
    assert len(meshed._replicas) == 1 and meshed.match_waveforms(queries, shifts=4) == single
    assert sum(v[0] == "MATCH" for v in single) >= 15
    idx = DejavuDeviceIndex()
    idx.ingest_arrays(names, tracks, device=cuda_device)
    dj_single = DejavuDeviceMatcher(idx, device=cuda_device).match_waveforms(queries)
    assert DejavuDeviceMatcher(idx, mesh=mesh).match_waveforms(queries) == dj_single


@pytest.mark.cuda
def test_sharded_augmenter_on_card_equals_apply(cuda_device):
    from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
    from musicfpaugment_torch.parallel import ShardedAugmenter
    from musicfpaugment_torch.testing.parameters import default_parameters

    nb, ib = synthetic_banks(sample_rate=8000, noise_row_length=8 * 8000, device=cuda_device)
    fp = AugmentFP(nb, 8000, parameters=default_parameters, impulse_response_dir=ib, device=cuda_device)
    _, queries = _mesh_corpus(n_queries=256)
    x = torch.from_numpy(queries).to(cuda_device)
    shards = ShardedAugmenter(fp, [cuda_device, cuda_device]).batch_augment(x, key=prng.key(42))
    whole = fp.apply(x, fp.draw(256, x.shape[-1], prng.key(42)))
    assert int((torch.cat(shards) != whole).sum()) == 0


@pytest.mark.cuda
def test_cqt_on_card_matches_cpu(cuda_device):
    from musicfpaugment_torch.train.cqt import cqt_magnitude, multi_resolution_cqt_loss

    x = torch.from_numpy(next(synthetic_clean_batches(4, 3 * 8000, 8000, seed=94)))
    y = x + 0.2 * torch.from_numpy(next(synthetic_clean_batches(4, 3 * 8000, 8000, seed=95)))
    got = cqt_magnitude(x.to(cuda_device)).cpu()
    want = cqt_magnitude(x)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    for g, w in zip(multi_resolution_cqt_loss(x.to(cuda_device), y.to(cuda_device)),
                    multi_resolution_cqt_loss(x, y)):
        assert abs(float(g) - float(w)) <= 1e-5 * abs(float(w))


@pytest.mark.cuda
def test_ddp_world_one_nccl_step_on_card(cuda_device, tmp_path):
    """A world-1 NCCL group: three DDP steps within 1e-6 of the plain ones
    from one seed (on one rank the BatchNorm keeps its local statistics)."""
    import socket

    import torch.distributed as dist

    from musicfpaugment_torch.parallel import init_multihost
    from musicfpaugment_torch.train.trainer import Trainer

    clean = next(synthetic_clean_batches(8, 3 * 8000, 8000, seed=96))
    aug = (0.7 * clean + 0.1 * np.random.default_rng(0).standard_normal(clean.shape)).astype(np.float32)
    losses = {}
    for label in ("plain", "ddp"):
        if label == "ddp":
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            init_multihost(f"tcp://127.0.0.1:{port}", world_size=1, rank=0, device=cuda_device)
        try:
            torch.manual_seed(3)
            tt = Trainer(UNet(1, 1, rate=0.0, base=8), iter(()), 1, iter(()), 1, 1e-3, 2,
                         str(tmp_path / label), input_type="spec", device=cuda_device)
            losses[label] = [float(tt.train_step(clean, aug)["loss"]) for _ in range(3)]
            losses[label + "_module"] = type(tt._train_model).__name__
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    assert losses["ddp_module"] == "DistributedDataParallel" and losses["plain_module"] == "UNet"
    assert max(abs(a - b) for a, b in zip(losses["plain"], losses["ddp"])) <= 1e-6


@pytest.mark.cuda
def test_log_media_and_app_on_card(cuda_device, tmp_path):
    from musicfpaugment_torch.apps import streamlit_app
    from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
    from musicfpaugment_torch.train.trainer import Trainer

    calls = []

    class Writer:
        def add_scalar(self, *a, **k):
            calls.append(a)

        def add_audio(self, *a, **k):
            calls.append(a)

        def add_image(self, tag, img, step, dataformats):
            calls.append((tag, np.asarray(img)))

    nb, ib = synthetic_banks(sample_rate=8000, noise_row_length=3 * 8000, device=cuda_device)
    fp = AugmentFP(nb, 8000, impulse_response_dir=ib, device=cuda_device)
    val = iter([next(synthetic_clean_batches(4, 3 * 8000, 8000, seed=97))])
    tt = Trainer(UNet(1, 1, rate=0.05, base=8), iter(()), 1, val, 1, 1e-3, 2, str(tmp_path),
                 input_type="spec", augmenter=fp, monitoring=True, device=cuda_device, writer=Writer())
    tt._log_media(10)
    assert len(calls) == 9
    assert all(img.shape == (257, 94, 1) and np.isfinite(img).all() and img.max() <= 1.0 for _, img in calls)

    class Panel:
        def markdown(self, *a, **k):
            pass

        def slider(self, label, min_value, max_value, step, value):
            return value

        def checkbox(self, label, value):
            return value

    model = streamlit_app.define_model(Panel())
    assert model.device.type == "cuda"
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (2, 1, 16000)).astype(np.float32)
    import io

    import scipy.io.wavfile

    for out in streamlit_app.process_audio(x, [16000, 16000], model):
        sr, y = scipy.io.wavfile.read(io.BytesIO(out))
        assert sr == 16000 and y.shape == (16000,) and np.abs(y.astype(np.float64) / 32767).max() <= 1


@pytest.mark.cuda
def test_prng_and_corpus_on_the_card_equal_the_cpu(cuda_device):
    """Threefry words, uniforms, randints and gates bit for bit; normals
    within 2 ulp (the devices' log1p); corpus tracks within 1e-5 of the
    peak."""
    from musicfpaugment_torch.data.synthetic import synth_tracks_device

    keys = prng.split(prng.key(42), 256)
    on_card = keys.to(cuda_device)
    for fn in (lambda k: prng.split(k, 8), lambda k: prng.fold_in(k, 77),
               lambda k: prng.uniform(k, (64,), 80.0, 3500.0),
               lambda k: prng.randint(k, (64,), 0, 271), lambda k: prng.bernoulli(k, 0.3, (64,))):
        assert torch.equal(fn(on_card).cpu(), fn(keys))
    want = prng.normal(keys, (64,)).numpy()
    got = prng.normal(on_card, (64,)).cpu().numpy()
    assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()
    a = synth_tracks_device(1234, range(4), 30 * 8000, device=cuda_device).cpu()
    b = synth_tracks_device(1234, range(4), 30 * 8000, device="cpu")
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_matches_plain_forward_and_backward(cuda_device, dtype):
    """The fused threefry dropout against its plain version on the same card
    tensors, at odd shapes and a rank's batch offset: every element of the
    output and of the gradient bit for bit; one launch each way."""
    from musicfpaugment_torch.models import dropout as tdrop

    key = prng.flax_fold(prng.key(5), "Dropout_3", 1)
    for shape, offset in (((3, 5, 7, 11), 0), ((2, 64, 17, 3), 6), ((1, 1, 1, 300), 1)):
        x = torch.randn(shape, device=cuda_device).to(dtype)
        g = torch.randn(shape, device=cuda_device).to(dtype)
        xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        tdrop.reset_launch_counts()
        yk = tdrop.dropout(xk, key, 0.05, offset)
        yp = tdrop.dropout_plain(xp, key, 0.05, offset)
        yk.backward(g)
        yp.backward(g)
        assert tdrop.LAUNCHES["dropout_threefry"] == 2
        assert torch.equal(yk, yp) and torch.equal(xk.grad, xp.grad)
        assert bool((yk == 0).any()) and bool((yk != 0).any())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tdrop.dropout(torch.ones(1, 1, 1, 4, dtype=torch.float64, device=cuda_device), key, 0.05)


@pytest.mark.cuda
def test_flax_init_on_card_equals_cpu(cuda_device):
    """``flax_init`` draws on the model's device: the UNet's weights on the
    card equal the CPU's (``erf_inv``'s ``log1p`` is taken in float64 on
    both) to an ulp; a rate-0.05 training forward takes the kernel."""
    from musicfpaugment_torch.models import dropout as tdrop
    from musicfpaugment_torch.models import flax_init

    card = flax_init(UNet(1, 1, rate=0.05, base=8).to(cuda_device))
    cpu = flax_init(UNet(1, 1, rate=0.05, base=8))
    for k, want in cpu.state_dict().items():
        got = card.state_dict()[k].cpu()
        if want.is_floating_point():
            ulp = torch.from_numpy(np.spacing(want.abs().numpy()))
            assert bool(((got - want).abs() <= ulp).all()), k
        else:
            assert torch.equal(got, want), k
    tdrop.reset_launch_counts()
    card.train()(torch.rand(2, 33, 20, device=cuda_device), dropout_key=prng.key(1))
    assert tdrop.LAUNCHES["dropout_threefry"] == 5

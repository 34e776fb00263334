"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the audfprint identification path of ``musicfpaugment_torch`` end to
end on the card, clean and degraded queries, and the training of its UNet
denoiser, through the entry points a user calls:

1. device  - the card's name and power limit;
2. build   - compiles the CUDA kernels from ``musicfpaugment_torch/csrc``;
3. kernels - each prune kernel against its plain PyTorch version on the same
             card tensors, at the shapes the path gives it (a 128-query
             batch of 8 s crops; the 512 rows of that batch's 4 stacked
             shifts, 251 and 250 columns; a 64-track ingest batch of
             20-30 s tracks, mixed lengths), with times, bounds and mismatch
             counts, which must be 0;
4. ingest  - 10,000 synthetic 20-30 s tracks, generated on the card, indexed
             by ``create_fp_database`` into a full 2^20 x 100 ``HashTable``;
5. match   - ``compute_accuracy_batched`` (batch 128, 4 shifts) over 1,024
             clean 8 s crops of indexed tracks, which must reach accuracy
             0.99; 128 crops of tracks never indexed; one batch re-run with
             the plain prunes on the card, which must give the same verdicts;
6. banks   - ``dcase_shaped_banks()`` at its defaults (3 h of noise in 15
             scenes, 271 impulse responses), built on the host and put on
             the card;
7. augment - ``AugmentFP`` with ``freeze_parameters(42)`` and
             ``batch_augment_indexed`` (batch 256) over the same 1,024 clean
             crops under each of the paper's 10 conditions: examples/s; every
             output finite with peak 1, a zero input staying zero; one batch
             of 16 against the same draws on the CPU (at most 1e-5 apart);
             the achieved SNR of the noise-only conditions' first batch
             (within 0.2 dB of the drawn one);
             the chain's variants, its stages and the two convolution routes
             timed;
8. conditions - ``compute_accuracy_batched`` on each condition's augmented
             queries with the ``DeviceMatcher`` of phase 5: accuracy and
             queries/s per condition;
9. profile - one match batch, one ingest batch, one ``batch_augment`` call
             and one denoised match batch under torch.profiler: wall time,
             device time, the card's busy share, the top ops;
10. unet   - ``UNet(1, 1)`` at ``base=64`` with weights from a numpy seed:
             its parameter and operation counts, and a forward of 128
             spectrograms of degraded queries in strict float32 (the port's
             default), with TF32 allowed and with bfloat16 compute: ms,
             TFLOP/s, peak memory, and how far the two faster ones move the
             output; the card against the CPU on 2 spectrograms in strict
             float32 (at most 1e-3 of the largest output);
11. denoised - a ``base=64`` UNet whose weights make it the identity on
             non-negative input as the second analyzer's spectrogram
             denoiser: ``compute_accuracy_batched`` with both analyzers over
             the first 256 clean and the first 256 ``default_parameters``
             queries (batch 128, 4 shifts), which must return the three
             accuracies, "With Denoising" within 2/256 of "No Denoising" and
             "Mix Pipeline" no lower than either less 2/256; one batch's
             peak masks with and without the hook (equal in >= 0.999 of
             cells); queries/s of the call and of the denoised arm alone;
12. peaks_metrics - ``compute_peaks_metrics_batched`` over the same 256
             ``default_parameters`` queries against their clean crops, read
             from ``.npy`` files in a temporary directory: eight finite
             numbers, ``f1_den`` within 1e-3 of ``f1_score_no_den``,
             ``psnr_den_spec`` within 0.01 dB of ``psnr_no_den_spec``;
13. train_step_check - one strict float32 "spec" step of ``UNet(base=8,
             rate=0)`` through ``Trainer.train_step`` on the card and on the
             CPU from the same weights and batch: loss within 1e-5
             (relative) and running statistics within 1e-5 of their largest
             values; the same step in float64, every gradient within 1e-4;
             every convolution of the float32 card step recomputed in
             float64 from its own operands, within 1e-4 (TF32 anywhere in
             the backward pass reads ~3e-4);
14. train  - ``UNet(1, 1, rate=0.05, base=64)`` trained by ``Trainer`` on
             the card: batch 128 of 3 s synthetic clips, ``default_parameters``
             augmentation with ``dcase_shaped_banks()`` inside each step,
             lr 1e-3, 2 epochs of 16 steps and 4 validation batches, with
             checkpoints; once in strict float32 and once in bfloat16 from
             the same seeded weights: step ms, examples/s, TFLOP/s, peak
             memory, the card's busy share over one step, the baseline and
             per-epoch validation loss and PSNR (the loss must fall, every
             number be finite); then a resume from the float32 run's
             ``last_epoch`` that must run one more epoch;
15. trained_denoiser - phases 11 and 12 again with the float32 run's best
             checkpoint as the denoiser, in strict float32, with TF32 allowed
             and in bfloat16: the three accuracies, queries/s, the peak
             metrics, and how far the two faster ones move verdicts, peak
             masks and the denoised F1.

Every phase prints a JSON line. Launch counters are zeroed just before
ingest and read after match: both kernels must have launched in each (once
per ingest batch, once per match batch whatever the number of shifts). They
are zeroed again before the augmented conditions, before the denoised
accuracies, before the peak metrics and before the trained-denoiser runs,
and read after each.
The line before the last is the kernel table, the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero.

In the kernel table ``ms``, ``plain_ms`` and ``bound_ms`` are those of the
shape the match path launches (512 stacked rows), ``ms`` the launch on the
time-major tensors as the path calls it and ``wrapper_ms`` the (B, F, C)
wrapper with its transposed copies; ``query_*`` and ``ingest_*`` are the same
readings at the other two shapes.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from musicfpaugment_torch import _build
from musicfpaugment_torch.afp.audfprint import DeviceMatcher, HashTable
from musicfpaugment_torch.afp.audfprint import peaks as P
from musicfpaugment_torch.afp.audfprint import peaks_cuda as K
from musicfpaugment_torch.afp.audfprint.analyzer import (
    AudfprintPeaks,
    pad_waveform_batch,
    valid_frames_for,
)
from musicfpaugment_torch.augment import AugmentFP, dcase_shaped_banks
from musicfpaugment_torch.augment import transforms as T
from musicfpaugment_torch.convert import unet_denoiser
from musicfpaugment_torch.core import filters
from musicfpaugment_torch.core.convolve import fft_convolve
from musicfpaugment_torch.data.synthetic import synth_tracks_device, synthetic_clean_batches
from musicfpaugment_torch.device import cudnn_tf32
from musicfpaugment_torch.models import UNet
from musicfpaugment_torch.testing.audfprint_exps import (
    PEAKS_METRICS,
    compute_accuracy_batched,
    compute_peaks_metrics_batched,
    create_fp_database,
)
from musicfpaugment_torch.testing.parameters import (
    afp_settings,
    test_pipelines_parameters,
)
from musicfpaugment_torch.train import parameters as TP
from musicfpaugment_torch.train.trainer import EarlyStopping, ReduceLROnPlateau, Trainer

SR = 8000
N_TRACKS = 10_000
TRACK_SECONDS = (20, 30)
QUERY_SECONDS = 8
N_QUERIES = 1024
N_UNSEEN = 128
QUERY_BATCH = 128
INGEST_BATCH = 64
SHIFTS = 4
CORPUS_SEED = 2023
UNSEEN_SEED = 4049
MIN_CLEAN_ACCURACY = 0.99  # the JAX package's 106k-track proof measured 1.0
AUGMENT_BATCH = 256
AUGMENT_SEED = 42
BANK_HOURS = 3.0  # dcase_shaped_banks' default
MIN_ACCURACY = {"bn_p10": 0.95, "recording_device": 0.95}
# On outputs whose peak is 1: float32 rounding reads about 1e-6, a
# convolution or transform at TF32 or lower precision about 1e-3.
MAX_CARD_VS_CPU = 1e-5
MAX_SNR_ERR_DB = 0.2
UNET_SEED = 64
UNET_BATCH = 128
DENOISED_QUERIES = 256
# relative to the largest output: float32 rounding through 23 layers reads
# about 1e-5, TF32 about 1e-3
MAX_UNET_CARD_VS_CPU = 1e-3
MIN_MASK_AGREEMENT = 0.999
ACCURACY_SLACK = 2 / DENOISED_QUERIES
MAX_F1_GAP = 1e-3
MAX_PSNR_GAP_DB = 0.01
# training: the JAX CLI's UNet run (lr 1e-3, batch 128, 3 s clips, factor
# 0.5 losses) cut to 2 epochs of 16 steps and 4 validation batches
TRAIN_SAMPLES = TP.DURATION * SR
TRAIN_STEPS = 16
TRAIN_VAL_STEPS = 4
TRAIN_EPOCHS = 2
TRAIN_LR = 1e-3
# card against CPU on one strict float32 step, relative to the largest
# value: float32 rounding reads ~1e-6, TF32 convolutions ~1e-3
MAX_STEP_LOSS_REL = 1e-5
MAX_STEP_GRAD_REL = 1e-4
MAX_STEP_STATS_REL = 1e-5
MAX_CONV_BACKWARD_REL = 1e-4

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_ms(fn, reps: int) -> float:
    """Mean ms per call on the card's clock, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def track_lengths(n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    return r.integers(TRACK_SECONDS[0] * SR, TRACK_SECONDS[1] * SR + 1, n)


def make_tracks(seed: int, n: int, lengths: np.ndarray, dev) -> list:
    """n tracks on the card, track i a pure function of (seed, i), each cut
    to its own length."""
    out = []
    for s in range(0, n, 128):
        idx = list(range(s, min(s + 128, n)))
        block = synth_tracks_device(seed, idx, TRACK_SECONDS[1] * SR, SR, device=dev)
        out += [block[j, : int(lengths[i])] for j, i in enumerate(idx)]
    return out


def crops_of(tracks, ids, offsets) -> list:
    n = QUERY_SECONDS * SR
    return [tracks[int(t)][int(o) : int(o) + n] for t, o in zip(ids, offsets)]


def prune_work(x, fwd, bwd, vf):
    """Bytes each prune must move and f32 operations it does on these
    inputs (counted from this run's masks: one argmax round and one bump per
    forward peak, one bump per kept peak)."""
    B, F, C = x.shape
    cells = B * F * C
    valid_cols = B * C if vf is None else int(vf.sum())
    tested = int(fwd.sum())
    spread = 2 * B * F * F  # initial envelope
    fwd_ops = 5 * cells + F * tested + 2 * F * tested + spread
    bwd_ops = 2 * F * valid_cols + F * tested + 2 * F * int(bwd.sum()) + spread
    fwd_bytes = cells * 4 + cells + F * 4
    bwd_bytes = cells * 4 + 2 * cells + F * 4 + B * 4
    return (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops)


def bound(bytes_, ops):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(name, x, vf, sm_mhz):
    """Kernel vs plain on the same card tensors at one path shape: 0
    mismatching cells required. ``ms`` times the (B, F, C) wrapper (the
    transposed copies and the launch), ``kernel_ms`` the launch alone on the
    time-major tensors, as the path calls it, ``step_cycles_at_max_clock``
    that launch per column of the longest row, reckoned at the card's maximum
    SM clock (the clock the run had is not read)."""
    a_dec = P.prune_decay(20.0, 256)
    fk = K.forward_prune_cuda(x, a_dec)
    fp = P.forward_prune(x, a_dec, 30.0, 5)
    bk = K.backward_prune_cuda(x, fp, a_dec, 30.0, 5, vf)
    bp = P.backward_prune(x, fp, a_dec, 30.0, 5, vf)
    tm = x.transpose(1, 2).contiguous()
    fk_tm = K.forward_prune_tm(tm, a_dec)
    bk_tm = K.backward_prune_tm(tm, fk_tm, a_dec, 30.0, 5, vf)
    torch.cuda.synchronize()
    (fb, fo), (bb, bo) = prune_work(x, fp, bp, vf)
    steps = x.shape[2] if vf is None else int(vf.max())
    out = {}
    for kname, got, got_tm, want, kfn, tmfn, pfn, nbytes, nops in (
        ("forward_prune", fk, fk_tm, fp,
         lambda: K.forward_prune_cuda(x, a_dec),
         lambda: K.forward_prune_tm(tm, a_dec),
         lambda: P.forward_prune(x, a_dec, 30.0, 5), fb, fo),
        ("backward_prune", bk, bk_tm, bp,
         lambda: K.backward_prune_cuda(x, fp, a_dec, 30.0, 5, vf),
         lambda: K.backward_prune_tm(tm, fk_tm, a_dec, 30.0, 5, vf),
         lambda: P.backward_prune(x, fp, a_dec, 30.0, 5, vf), bb, bo),
    ):
        mism = int((got != want).sum()) + int((K.as_bool_masks(got_tm) != want).sum())
        b_ms, b_by = bound(nbytes, nops)
        kernel_ms = gpu_ms(tmfn, 20)
        out[kname] = {
            "shape": name, "B": x.shape[0], "F": x.shape[1], "C": x.shape[2],
            "mismatch": mism,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "peaks": int(want.sum()),
            "ms": gpu_ms(kfn, 20), "kernel_ms": kernel_ms,
            "step_cycles_at_max_clock": kernel_ms * 1e-3 * sm_mhz * 1e6 / steps,
            "plain_ms": gpu_ms(pfn, 2),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": nops,
        }
        if mism:
            fail(f"{kname} at the {name} shape disagrees with its plain version "
                 f"in {mism} cells")
    return out


def wall_ms(fn, reps: int) -> float:
    """Mean ms per call on the host's clock, synchronised, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def augment_condition(fp, clean):
    """``clean`` (N, T) through ``fp``'s frozen-seed chain in batches of
    AUGMENT_BATCH, example i under index i. Returns (outputs, seconds)."""
    fp.freeze_parameters(AUGMENT_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = torch.cat([
        fp.batch_augment_indexed(clean[s : s + AUGMENT_BATCH],
                                 range(s, min(s + AUGMENT_BATCH, len(clean))))
        for s in range(0, len(clean), AUGMENT_BATCH)
    ])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_augmented(name, fp, clean, out):
    """Finite, every row's peak 1 within 1e-6, a zero input staying zero."""
    if out.shape != clean.shape or not bool(torch.isfinite(out).all()):
        fail(f"{name}: augmented queries of shape {tuple(out.shape)} or not finite")
    peak_err = float((out.abs().amax(-1) - 1.0).abs().max())
    if peak_err > 1e-6:
        fail(f"{name}: a row's peak is {peak_err} away from 1")
    pair = torch.stack([clean[0], torch.zeros_like(clean[0])])
    if float(fp.batch_augment_indexed(pair, [0, len(clean)])[1].abs().max()) != 0.0:
        fail(f"{name}: an all-zero input did not stay zero")
    return peak_err


def achieved_snr(fp, clean, out) -> dict:
    """A noise-only condition on the card: ``out`` is a * clean + b * noise
    with the noise crop that the same draws name, so least squares on the
    pair gives the two gains and 20 log10(rms(a clean) / rms(b noise)) is
    the SNR that the mix reached, beside the one drawn."""
    n = clean.shape[0]
    draws = fp.draw_indexed(range(n), clean.shape[-1], AUGMENT_SEED)[2]
    noise = fp.noise_bank.crop(
        draws["scene"], draws["row_u"], draws["offset"], clean.shape[-1]).double()
    x, y = clean.double(), out.double()
    xx, xn, nn = (x * x).sum(-1), (x * noise).sum(-1), (noise * noise).sum(-1)
    yx, yn = (y * x).sum(-1), (y * noise).sum(-1)
    det = xx * nn - xn * xn
    a, b = (yx * nn - yn * xn) / det, (yn * xx - yx * xn) / det
    reached = 10 * torch.log10(a * a * xx / (b * b * nn))
    drawn = draws["snr_db"].to(reached)
    return {"drawn_db": float(drawn[0]), "reached_db_min": float(reached.min()),
            "reached_db_max": float(reached.max()),
            "max_err_db": float((reached - drawn).abs().max())}


def stage_times(fp, x) -> dict:
    """Device ms of each stage of ``fp``'s chain on one batch, stage by
    stage on the output of the stage before, and of the two fused pairs."""
    draws = fp.draw(x.shape[0], x.shape[-1], torch.Generator().manual_seed(1))
    tfms = fp.pipeline.transforms
    banks = {"noise_bank": fp.noise_bank, "ir_bank": fp.ir_bank}
    out, inputs = {}, [x]
    for i, t in enumerate(tfms):
        inputs.append(t.apply(inputs[i], draws[i], fp.sample_rate, **banks))
        out[f"{i}_{type(t).__name__}"] = gpu_ms(
            lambda: t.apply(inputs[i], draws[i], fp.sample_rate, **banks), 5)
    out["fused_0_1_highpass_ir"] = gpu_ms(
        lambda: T.fused_highpass_ir(x, draws[0], draws[1], tfms[0], fp.ir_bank), 5)
    out["fused_5_6_lowpass_highpass"] = gpu_ms(
        lambda: T.fused_lowpass_highpass(inputs[5], draws[5], draws[6], tfms[5], tfms[6]), 5)
    out["draw_host_ms"] = wall_ms(lambda: fp.draw(x.shape[0], x.shape[-1]), 5)
    out["draw_indexed_host_ms"] = wall_ms(
        lambda: fp.draw_indexed(range(x.shape[0]), x.shape[-1], AUGMENT_SEED), 5)
    return out


def conv_routes(dev) -> dict:
    """Direct grouped convolution (cuDNN on, TF32 off, as the port runs it)
    against the FFT route at (256, 64000) with 33 to 513 taps: ms of each,
    their difference, and what TF32 would change on the direct route (its ms
    and its error against float64). ``cudnn_enabled`` is read inside the
    direct route's call."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((AUGMENT_BATCH, QUERY_SECONDS * SR), generator=g).to(dev)
    seen = []
    conv1d = filters.F.conv1d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.enabled)
        return conv1d(*args, **kwargs)

    out = {}
    for half in (16, 64, 128, 256):
        taps = 2 * half + 1
        kernels = filters.lowpass_kernels(torch.linspace(0.05, 0.45, AUGMENT_BATCH).to(dev), half)
        padded = filters._edge_pad(x, half)
        filters.F.conv1d = spy
        try:
            direct = filters._direct_conv_valid(padded, kernels)
        finally:
            filters.F.conv1d = conv1d
        by_fft = fft_convolve(padded, kernels, mode="valid")
        exact = filters._direct_conv_valid(padded.double(), kernels.double())
        k = torch.flip(kernels, dims=[-1])[:, None, :]

        def tf32_direct():
            with cudnn_tf32(True):
                return torch.nn.functional.conv1d(padded[None], k, groups=AUGMENT_BATCH)[0]

        out[f"{taps}_taps"] = {
            "direct_ms": gpu_ms(lambda: filters._direct_conv_valid(padded, kernels), 10),
            "direct_tf32_allowed_ms": gpu_ms(tf32_direct, 10),
            "fft_ms": gpu_ms(lambda: fft_convolve(padded, kernels, mode="valid"), 10),
            "direct_vs_fft_max_abs": float((direct - by_fft).abs().max()),
            "direct_err_vs_float64": float((direct - exact).abs().max()),
            "fft_err_vs_float64": float((by_fft - exact).abs().max()),
            "direct_tf32_allowed_err_vs_float64": float((tf32_direct() - exact).abs().max()),
        }
    if seen != [True] * len(out):
        fail(f"cuDNN was off inside the filters' direct route: {seen}")
    out["cudnn_enabled"] = True
    return out


def seeded_unet(seed: int) -> UNet:
    """``UNet(1, 1)`` at ``base=64`` on the CPU with weights from a numpy
    generator: kernels scaled by their fan-in so that activations stay of
    order 1, BatchNorm scales, biases and running statistics not trivial."""
    model = UNet(1, 1)
    rng = np.random.default_rng(seed)

    def draw(like, kind, scale=1.0):
        if kind == "normal":
            a = rng.standard_normal(like.shape, dtype=np.float32) * scale
        else:
            a = rng.uniform(scale[0], scale[1], like.shape).astype(np.float32)
        return torch.from_numpy(a)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                m.weight.copy_(draw(m.weight, "normal", math.sqrt(2.0 / fan_in)))
            elif isinstance(m, torch.nn.ConvTranspose2d):  # one tap per output pixel
                m.weight.copy_(draw(m.weight, "normal", math.sqrt(1.0 / m.in_channels)))
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(draw(m.weight, "uniform", (0.8, 1.2)))
                m.running_mean.copy_(draw(m.running_mean, "normal", 0.1))
                m.running_var.copy_(draw(m.running_var, "uniform", (0.5, 1.5)))
            if getattr(m, "bias", None) is not None:
                m.bias.copy_(draw(m.bias, "normal", 0.1))
    return model.eval()


def make_identity_unet(model: UNet) -> UNet:
    """Give a ``UNet(1, 1)`` the weights that make it the identity on
    non-negative input: centre taps along the skip path inc -> up4 -> outc,
    unit BatchNorm, zeros everywhere else (the deeper levels still run).
    Returns the model in eval mode."""
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.running_mean.zero_()
                m.running_var.fill_(1.0 - m.eps)
        # up4's first input channels are the skip's: concat is [skip, upsampled]
        for conv in (model.inc.conv1, model.inc.conv2, model.up4.conv.conv1, model.up4.conv.conv2):
            conv.weight[0, 0, 1, 1] = 1.0
        model.outc.weight[0, 0, 0, 0] = 1.0
    return model.eval()


def unet_forward_flops(model: UNet, x: torch.Tensor) -> int:
    """Multiply-adds x 2 of one forward of ``x``, summed over the
    convolutions from the shapes they saw (the element-wise layers are not
    counted)."""
    total = 0

    def count(mod, args, out):
        nonlocal total
        taps = mod.kernel_size[0] * mod.kernel_size[1]
        if isinstance(mod, torch.nn.ConvTranspose2d):
            total += 2 * args[0].numel() * mod.out_channels * taps
        else:
            total += 2 * out.numel() * mod.in_channels * taps

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return total


def unet_phase(dev, sgrams: torch.Tensor) -> dict:
    """Phase 10 on ``sgrams`` (UNET_BATCH, 257, 251), normalised magnitudes
    of degraded queries."""
    on_cpu = seeded_unet(UNET_SEED)
    strict = copy.deepcopy(on_cpu).to(dev)
    bf16 = UNet(1, 1, dtype=torch.bfloat16).to(dev).eval()
    bf16.load_state_dict(strict.state_dict())
    strict_hook, bf16_hook = unet_denoiser(strict), unet_denoiser(bf16)

    def tf32_hook(x):  # the same layers, TF32 allowed around them
        with torch.inference_mode(), cudnn_tf32(True):
            return strict.outc(strict.body(x[:, None]))[:, 0]

    flops_one = unet_forward_flops(strict, sgrams[:1])
    baseline = torch.cuda.memory_allocated()
    runs = {}
    for label, hook in (("float32", strict_hook), ("tf32_allowed", tf32_hook),
                        ("bfloat16", bf16_hook)):
        torch.cuda.reset_peak_memory_stats()
        ms = gpu_ms(lambda: hook(sgrams), 2)
        runs[label] = {
            "ms": ms, "tflop_per_s": flops_one * sgrams.shape[0] / ms / 1e9,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_bytes_above_start": torch.cuda.max_memory_allocated() - baseline,
        }
    few = sgrams[:8]
    want = strict_hook(few)
    top = float(want.abs().max())
    for label, hook in (("tf32_allowed", tf32_hook), ("bfloat16", bf16_hook)):
        runs[label]["max_err_vs_float32_rel"] = float((hook(few) - want).abs().max()) / top
    t0 = time.perf_counter()
    cpu_out = unet_denoiser(on_cpu)(sgrams[:2].cpu())
    cpu_s = time.perf_counter() - t0
    card_vs_cpu = float((want[:2].cpu() - cpu_out).abs().max()) / float(cpu_out.abs().max())
    line = {
        "phase": "unet", "base": strict.base, "seed": UNET_SEED,
        "parameters": sum(p.numel() for p in strict.parameters()),
        "input": list(sgrams.shape), "flops_one_forward": flops_one,
        "output_max_abs": top, "output_finite": bool(torch.isfinite(want).all()),
        "forward": runs, "card_vs_cpu_rel": card_vs_cpu, "card_vs_cpu_examples": 2,
        "cpu_forward_s": cpu_s,
    }
    emit(line)
    if not line["output_finite"] or want.shape != few.shape:
        fail(f"the UNet's output is not finite or of shape {tuple(want.shape)}")
    if not card_vs_cpu <= MAX_UNET_CARD_VS_CPU:
        fail(f"the UNet on the card is {card_vs_cpu} of its largest output away from the CPU")
    return line


def plain_tm(mask: torch.Tensor) -> torch.Tensor:
    """(B, F, C) bool mask of a plain prune -> the (B, C, F) 0/1 bytes the
    kernels' route carries."""
    return mask.transpose(1, 2).to(torch.uint8).contiguous()


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)


def profile_call(label: str, fn) -> dict:
    """One call's wall time (plain, then under torch.profiler), the summed
    device time of its kernels, the card's busy share and the top ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events (kernels, copies) carry the card's time once; the
    # host ops that launched them repeat it, so they only rank
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    host_ops = [e for e in events if e.device_type != DeviceType.CUDA]
    device_ms = sum(_device_us(e) for e in on_card) / 1e3

    def top(evts, n=8):
        return [
            {"name": e.key[:80], "device_ms": _device_us(e) / 1e3, "count": e.count}
            for e in sorted(evts, key=_device_us, reverse=True)[:n]
        ]

    prune_ms = sum(
        _device_us(e) for e in on_card if "fwd_kernel" in e.key or "bwd_kernel" in e.key
    ) / 1e3
    # the kernels of a cuDNN convolution, whatever their names, are counted
    # on the host op that launched them
    conv_ms = sum(
        _device_us(e) for e in host_ops
        if e.key in ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose")
    ) / 1e3
    return {
        "phase": "profile", "call": label, "wall_ms": wall_ms,
        "traced_wall_ms": traced_ms, "device_ms": device_ms,
        "busy_share": device_ms / traced_ms,
        "prune_kernels_device_ms": prune_ms,
        "prune_kernels_share_of_device": prune_ms / device_ms,
        "cudnn_convolutions_device_ms": conv_ms,
        "cudnn_convolutions_share_of_device": conv_ms / device_ms,
        "top_ops": top(host_ops), "top_kernels": top(on_card),
    }


def _rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def conv_backward_probe(model: torch.nn.Module):
    """Hooks on every convolution of ``model``. After a backward pass,
    ``check()`` recomputes each layer's weight and input gradients in
    float64 from the operands the layer saw and returns the largest
    difference relative to the tensor's largest value: 1e-7 to 3e-5 for a
    float32 backward (sums of 1e4-1e5 products), ~3e-4 for one that took
    TF32. The operands are the run's own, so the check does not depend
    on the ReLU and max-pool decisions of the forward pass."""
    seen = {}

    def forward_hook(mod, args, out):
        # the weights as the forward pass used them: the optimizer moves them
        seen[mod] = [args[0].detach(), None, None,
                     {k: v.detach().clone() for k, v in mod.named_parameters()}]

    def backward_hook(mod, grad_input, grad_output):
        seen[mod][1] = grad_output[0].detach()
        seen[mod][2] = None if grad_input[0] is None else grad_input[0].detach()

    hooks = []
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            hooks.append(m.register_forward_hook(forward_hook))
            hooks.append(m.register_full_backward_hook(backward_hook))

    def check() -> float:
        for h in hooks:
            h.remove()
        worst = 0.0
        for mod, (x, g_out, g_in, weights) in seen.items():
            ref = copy.deepcopy(mod)
            ref.load_state_dict(weights)
            ref.double().zero_grad(set_to_none=True)
            x64 = x.double().requires_grad_(g_in is not None)
            ref(x64).backward(g_out.double())
            pairs = [(mod.weight.grad, ref.weight.grad)]
            if mod.bias is not None:
                pairs.append((mod.bias.grad, ref.bias.grad))
            if g_in is not None:
                pairs.append((g_in, x64.grad))
            worst = max([worst] + [_rel_max(a.double(), b) for a, b in pairs])
        return worst

    return check


def train_step_check(dev) -> dict:
    """One strict float32 "spec" step of ``UNet(base=8, rate=0)`` through
    ``Trainer.train_step`` on the card and on the CPU from the same weights
    and batch: the loss and the running statistics. The gradients of a ReLU
    network in float32 jump where rounding flips a ReLU or a max-pool
    choice (measured up to 8e-2 of a tensor's largest value between two
    float32 runs, either side as often as the other nearer float64), so
    the same step is compared again in float64, and every convolution of
    the float32 card step is recomputed in float64 from its own operands
    (``conv_backward_probe``): that is what catches TF32 in the backward
    pass."""
    clean = next(synthetic_clean_batches(8, TRAIN_SAMPLES, SR, seed=UNET_SEED))
    r = np.random.default_rng(UNET_SEED)
    aug = (0.7 * clean + 0.2 * r.standard_normal(clean.shape)).astype(np.float32)
    runs, probe_err = {}, None
    for label, device, dtype in (("cpu", "cpu", torch.float32), ("card", dev, torch.float32),
                                 ("cpu64", "cpu", torch.float64), ("card64", dev, torch.float64)):
        torch.manual_seed(UNET_SEED)
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(UNet(1, 1, rate=0.0, base=8).to(dtype), iter(()), 1, iter(()), 1,
                              TRAIN_LR, 2, tmp, input_type="spec", device=device)
        probe = conv_backward_probe(trainer.model) if label == "card" else None
        terms = trainer.train_step(torch.from_numpy(clean).to(device, dtype),
                                   torch.from_numpy(aug).to(device, dtype))
        if probe is not None:
            probe_err = probe()
        runs[label] = (
            float(terms["loss"]),
            {k: p.grad.cpu() for k, p in trainer.model.named_parameters()},
            {k: v.cpu() for k, v in trainer.model.state_dict().items() if "running_" in k},
        )
    (loss_c, grads_c, stats_c), (loss_g, grads_g, stats_g) = runs["cpu"], runs["card"]
    grads_c64, grads_g64 = runs["cpu64"][1], runs["card64"][1]
    line = {
        "phase": "train_step_check", "base": 8, "batch": clean.shape[0], "samples": clean.shape[1],
        "loss_cpu": loss_c, "loss_card": loss_g, "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
        "stats_rel_max": max(_rel_max(stats_g[k], stats_c[k]) for k in stats_c),
        "grad_rel_max_float64": max(_rel_max(grads_g64[k], grads_c64[k]) for k in grads_c64),
        "conv_backward_vs_float64_max": probe_err,
        "grad_rel_max_float32_not_held": max(_rel_max(grads_g[k], grads_c[k]) for k in grads_c),
        "grad_rel_max_float32_cpu_vs_float64_not_held": max(
            _rel_max(grads_c[k].double(), grads_c64[k]) for k in grads_c),
        "tensors": len(grads_c),
    }
    emit(line)
    if not line["loss_rel"] <= MAX_STEP_LOSS_REL:
        fail(f"train step: the card's loss is {line['loss_rel']} (relative) from the CPU's")
    if not line["stats_rel_max"] <= MAX_STEP_STATS_REL:
        fail(f"train step: running statistics {line['stats_rel_max']} from the CPU's")
    if not line["grad_rel_max_float64"] <= MAX_STEP_GRAD_REL:
        fail(f"train step: a float64 gradient on the card is {line['grad_rel_max_float64']} "
             "of its largest value from the CPU's")
    if not probe_err <= MAX_CONV_BACKWARD_REL:
        fail(f"train step: a convolution's backward on the card is {probe_err} of its largest "
             "value from float64 on the same operands (TF32 in the backward pass?)")
    return line


def train_phase(dev, noise_bank, ir_bank, ckpt_root: str) -> str:
    """The published UNet (base=64, rate 0.05) trained on the card with
    default_parameters augmentation inside each step, once in strict float32
    and once in bfloat16 from the same seeded weights: TRAIN_EPOCHS epochs of
    TRAIN_STEPS steps, checkpoints as ``--save`` writes them, then a resume
    from the float32 run's ``last_epoch`` and one more epoch. Returns the
    float32 run's best checkpoint path."""
    params = test_pipelines_parameters["default_parameters"]
    fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device=dev)
    t0 = time.perf_counter()
    train_batches = [b for b, _ in zip(synthetic_clean_batches(TP.BATCH_SIZE, TRAIN_SAMPLES, SR, seed=59),
                                       range(TRAIN_STEPS))]
    val_batches = [b for b, _ in zip(synthetic_clean_batches(TP.BATCH_SIZE, TRAIN_SAMPLES, SR, seed=4),
                                     range(TRAIN_VAL_STEPS))]
    data_s = time.perf_counter() - t0

    def cycle(batches):
        while True:
            yield from batches

    def make(dtype, ckpt, nb_epochs):
        torch.manual_seed(UNET_SEED)
        return Trainer(
            UNet(1, 1, rate=0.05, base=64, dtype=dtype), cycle(train_batches), TRAIN_STEPS,
            cycle(val_batches), TRAIN_VAL_STEPS, TRAIN_LR, nb_epochs, ckpt, input_type="spec",
            augmenter=fp, factor_sc=TP.FACTOR_SC, factor_mag=TP.FACTOR_MAG,
            scheduler=ReduceLROnPlateau(factor=TP.FACTOR, patience=TP.PATIENCE),
            early_stopping=EarlyStopping(patience=TP.EARLY_STOP, min_delta=TP.MIN_DELTA),
            save=True, device=dev,
        )

    flops_forward = unet_forward_flops(
        UNet(1, 1, base=64).to(dev).eval(), torch.zeros((1, 257, 1 + TRAIN_SAMPLES // 256), device=dev))
    flops_step = 3 * flops_forward * TP.BATCH_SIZE  # forward + backward (two products)
    runs = {}
    for label, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        ckpt = os.path.join(ckpt_root, label)
        trainer = make(dtype, ckpt, TRAIN_EPOCHS + 1)
        times = []
        step = trainer.train_step

        def timed(*args, step=step, times=times):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            return out

        trainer.train_step = timed
        baseline_loss, baseline_metrics = trainer.validation_epoch()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        trainer.training_loop()
        loop_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        del trainer.train_step
        hist = trainer.history
        median_s = float(np.median(times))
        clean = torch.from_numpy(train_batches[0]).to(dev)
        prof = profile_call(f"train_step, UNet base=64 {label}, batch {TP.BATCH_SIZE} x 3 s",
                            lambda: trainer.train_step(clean))
        emit(prof)
        run = {
            "steps": len(times), "step_ms_median": median_s * 1e3,
            "step_ms_first": times[0] * 1e3, "step_ms_min": min(times) * 1e3,
            "step_ms_max": max(times) * 1e3,
            "examples_per_s": TP.BATCH_SIZE / median_s,
            "tflop_per_s": flops_step / median_s / 1e12,
            "busy_share": prof["busy_share"],
            "cudnn_convolutions_share_of_device": prof["cudnn_convolutions_share_of_device"],
            "peak_bytes": peak, "peak_bytes_above_start": peak - before,
            "loop_seconds": loop_s,
            "train_loss": [h["train"]["loss"] for h in hist],
            "val_loss": [baseline_loss["loss"]] + [h["val"]["loss"] for h in hist],
            "val_psnr": [baseline_metrics["psnr"]] + [h["metrics"]["psnr"] for h in hist],
        }
        runs[label] = run
        losses = run["train_loss"] + run["val_loss"] + run["val_psnr"]
        if not all(math.isfinite(v) for v in losses):
            fail(f"train {label}: a loss or PSNR is not finite: {losses}")
        if not run["val_loss"][-1] < run["val_loss"][0]:
            fail(f"train {label}: the validation loss did not fall: {run['val_loss']}")
        if label == "float32":
            meta_path = os.path.join(ckpt, "last_epoch", "trainer_meta.json")
            with open(meta_path) as f:
                meta = json.load(f)
            del trainer, prof
            torch.cuda.empty_cache()
            resumed = make(None, ckpt, TRAIN_EPOCHS + 1)
            start, step0 = resumed.epoch_start, resumed.step
            resumed.training_loop()
            run["resume"] = {
                "meta_keys": sorted(meta), "saved_epoch": meta["epoch"], "epoch_start": start,
                "step_at_resume": step0,
                "epochs_after_resume": len(resumed.history),
                "val_loss_after_resume": resumed.history[-1]["val"]["loss"] if resumed.history else None,
            }
            if sorted(meta) != ["best_val_loss", "early_stopping", "epoch", "scheduler"]:
                fail(f"trainer_meta.json keys {sorted(meta)}")
            if start != TRAIN_EPOCHS or len(resumed.history) != 1 or step0 != TRAIN_EPOCHS * TRAIN_STEPS:
                fail(f"resume from last_epoch: {run['resume']}")
            if not math.isfinite(run["resume"]["val_loss_after_resume"]):
                fail("the resumed epoch's validation loss is not finite")
            del resumed
        else:
            del trainer, prof
        torch.cuda.empty_cache()
    line = {
        "phase": "train", "model": "UNet(1, 1, rate=0.05, base=64)", "batch": TP.BATCH_SIZE,
        "samples": TRAIN_SAMPLES, "spectrogram": [257, 1 + TRAIN_SAMPLES // 256],
        "augmentation": "default_parameters, dcase_shaped_banks()", "lr": TRAIN_LR,
        "epochs": TRAIN_EPOCHS, "steps_per_epoch": TRAIN_STEPS, "val_steps": TRAIN_VAL_STEPS,
        "flops_forward_one": flops_forward, "flops_step": flops_step,
        "host_batches_seconds": data_s, "runs": runs,
    }
    emit(line)
    return os.path.join(ckpt_root, "float32", "best_epoch", "state.pt")


def trained_denoiser_phase(dev, ckpt_path, ht, dm, analyzer, queries, aug_default, q_names,
                           q_paths, cleans_dir) -> dict:
    """The denoised and peak-metric runs of phases 11 and 12 with the strict
    float32 checkpoint of the train phase in place of the identity weights, in
    strict float32, with TF32 allowed and in bfloat16; how far the two
    faster ones move verdicts, masks and the denoised F1."""
    state = torch.load(ckpt_path, map_location=dev, weights_only=True)["model"]
    strict = UNet(1, 1).to(dev)
    strict.load_state_dict(state)
    bf16 = UNet(1, 1, dtype=torch.bfloat16).to(dev)
    bf16.load_state_dict(state)
    strict_hook, bf16_hook = unet_denoiser(strict), unet_denoiser(bf16)

    def tf32_hook(x):  # the same layers, TF32 allowed around them
        with torch.inference_mode(), cudnn_tf32(True):
            return strict.outc(strict.body(x[:, None]))[:, 0]

    aug_batch = aug_default[:QUERY_BATCH]
    out, verdicts, masks = {}, {}, {}
    K.reset_launch_counts()
    for label, hook in (("float32", strict_hook), ("tf32_allowed", tf32_hook), ("bfloat16", bf16_hook)):
        den = AudfprintPeaks(afp_settings["audfprint"], denoising=True, denoising_model="unet",
                             spec_denoiser=hook, device=dev)
        masks[label] = P.find_peaks_batch(aug_batch, denoiser=hook)
        verdicts[label] = dm.match_waveforms(aug_batch, shifts=SHIFTS, denoiser=hook)
        torch.cuda.synchronize()
        sets = {}
        for name, qs in (("cleans", queries[:DENOISED_QUERIES]), ("default_parameters", list(aug_default))):
            t0 = time.perf_counter()
            acc = compute_accuracy_batched(qs, ht, analyzer, den, batch_size=QUERY_BATCH, shifts=SHIFTS,
                                           device_matcher=dm, names=q_names, device=dev)
            sets[name] = {"accuracy": acc, "queries_per_s": DENOISED_QUERIES / (time.perf_counter() - t0)}
        t0 = time.perf_counter()
        metrics = compute_peaks_metrics_batched(q_paths, analyzer, den, cleans_path=cleans_dir)
        out[label] = {"sets": sets, "peaks_metrics": metrics,
                      "peaks_metrics_queries_per_s": DENOISED_QUERIES / (time.perf_counter() - t0)}
        if set(metrics) != set(PEAKS_METRICS) or not all(math.isfinite(v) for v in metrics.values()):
            fail(f"trained denoiser {label}: peak metrics missing or not finite: {metrics}")
        for name, row in sets.items():
            if set(row["accuracy"]) != {"No Denoising", "With Denoising", "Mix Pipeline"}:
                fail(f"trained denoiser {label} {name}: accuracies {sorted(row['accuracy'])}")
    launches = dict(K.LAUNCHES)
    for label in ("tf32_allowed", "bfloat16"):
        out[label]["vs_float32"] = {
            "verdicts_equal": sum(a[:2] == b[:2] for a, b in zip(verdicts[label], verdicts["float32"]))
            / len(verdicts["float32"]),
            "mask_cells_equal": float((masks[label] == masks["float32"]).float().mean()),
            "f1_den_diff": out[label]["peaks_metrics"]["f1_den"] - out["float32"]["peaks_metrics"]["f1_den"],
        }
    line = {"phase": "trained_denoiser", "checkpoint": "train phase, float32, best_epoch",
            "queries": DENOISED_QUERIES, "shifts": SHIFTS, "mask_peaks_float32": int(masks["float32"].sum()),
            "precisions": out, "launches": launches}
    emit(line)
    for k, n in launches.items():
        if n <= 0:
            fail(f"{k} kernel did not launch in the trained-denoiser runs")
    return line


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    sm_mhz = float(clk.stdout.strip().splitlines()[0])
    emit({"phase": "device", "name": kind, "nvidia_smi": smi_line,
          "max_sm_mhz": sm_mhz, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib})

    # ---- corpus and queries (set-up, on the card)
    t0 = time.perf_counter()
    lengths = track_lengths(N_TRACKS, CORPUS_SEED)
    tracks = make_tracks(CORPUS_SEED, N_TRACKS, lengths, dev)
    r = np.random.default_rng(CORPUS_SEED + 1)
    q_ids = r.integers(0, N_TRACKS, N_QUERIES)
    q_offs = [r.integers(0, int(lengths[t]) - QUERY_SECONDS * SR) for t in q_ids]
    queries = crops_of(tracks, q_ids, q_offs)
    names = [f"track{i:05d}" for i in range(N_TRACKS)]
    u_len = track_lengths(N_UNSEEN, UNSEEN_SEED)
    unseen_tracks = make_tracks(UNSEEN_SEED, N_UNSEEN, u_len, dev)
    unseen = torch.stack(crops_of(unseen_tracks, range(N_UNSEEN), [SR] * N_UNSEEN))
    torch.cuda.synchronize()
    emit({"phase": "corpus", "tracks": N_TRACKS, "seconds": time.perf_counter() - t0,
          "samples": int(lengths.sum())})

    # ---- 3. kernels vs plain at the path's shapes
    q_batch = torch.stack(queries[:QUERY_BATCH])
    x_query = P.prune_input(q_batch)
    ing, valid = pad_waveform_batch(
        tracks[:INGEST_BATCH], pad_to=TRACK_SECONDS[1] * SR, device=dev
    )
    vf_ing = torch.as_tensor(valid_frames_for(valid.astype(np.int64)), dtype=torch.int32, device=dev)
    x_ingest = P.prune_input(ing, valid_frames=vf_ing)
    # the 4 shifts of the query batch as match_waveforms stacks them
    offs = [int(s / SHIFTS * 256) for s in range(SHIFTS)]
    x_stacked, vf_stacked, n_cols = P.stacked_prune_input([q_batch[:, o:] for o in offs])
    if tuple(x_stacked.shape) != (SHIFTS * QUERY_BATCH, 256, 251) or n_cols != [251, 250, 250, 250]:
        fail(f"unexpected stacked shape {tuple(x_stacked.shape)}, columns {n_cols}")
    at_query = check_kernels("query", x_query, None, sm_mhz)
    at_stacked = check_kernels("stacked", x_stacked, vf_stacked, sm_mhz)
    at_ingest = check_kernels("ingest", x_ingest, vf_ing, sm_mhz)
    emit({"phase": "kernels", "query": at_query, "stacked": at_stacked,
          "ingest": at_ingest})

    # ---- 4. ingest (launch counters zeroed just before the main path)
    K.reset_launch_counts()
    analyzer = AudfprintPeaks(afp_settings["audfprint"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ht = create_fp_database(
        tracks, None, analyzer=analyzer, batch_size=INGEST_BATCH,
        hash_tab=HashTable(), names=names, device=dev,
    )
    ingest_s = time.perf_counter() - t0
    launches_ingest = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    dm = DeviceMatcher(ht, device=dev)
    torch.cuda.synchronize()
    emit({
        "phase": "ingest", "tracks": N_TRACKS, "seconds": ingest_s,
        "tracks_per_s": N_TRACKS / ingest_s, "total_hashes": ht.totalhashes(),
        "table": [int(1 << ht.hashbits), int(ht.depth)], "eff_depth": dm.eff_depth,
        "eff_maxtime": dm.eff_maxtime, "device_table_bytes": dm.table_bytes(),
        "matcher_setup_s": time.perf_counter() - t0, "launches": launches_ingest,
    })
    if (ht.table.shape != (1 << 20, 100)) or len(ht.names) != N_TRACKS:
        fail("the ingest did not fill a 2^20 x 100 table with every track")

    # ---- 5. match
    t0 = time.perf_counter()
    acc = compute_accuracy_batched(
        queries, ht, analyzer, batch_size=QUERY_BATCH, shifts=SHIFTS,
        device_matcher=dm, names=[names[int(t)] for t in q_ids], device=dev,
    )
    match_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    unseen_v = dm.match_waveforms(unseen, shifts=SHIFTS)
    unseen_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    launches_match = {k: launches[k] - launches_ingest[k] for k in launches}
    nomatch = sum(v[0] == "NOMATCH" for v in unseen_v) / N_UNSEEN

    # one batch again with the plain prunes on the card: same verdicts
    kernel_v = dm.match_waveforms(q_batch, shifts=SHIFTS)
    fwd_k, bwd_k = K.forward_prune_tm, K.backward_prune_tm
    K.forward_prune_tm = lambda tm, a, f=30.0, m=5: plain_tm(
        P.forward_prune(tm.transpose(1, 2), a, f, m))
    K.backward_prune_tm = lambda tm, p, a, f=30.0, m=5, vf=None: plain_tm(
        P.backward_prune(tm.transpose(1, 2), K.as_bool_masks(p), a, f, m, vf))
    K.reset_launch_counts()
    try:
        plain_v = dm.match_waveforms(q_batch, shifts=SHIFTS)
    finally:
        K.forward_prune_tm, K.backward_prune_tm = fwd_k, bwd_k
    if any(K.LAUNCHES.values()):
        fail("the plain re-run launched a kernel")
    emit({
        "phase": "match", "queries": N_QUERIES, "shifts": SHIFTS, "accuracy": acc,
        "seconds": match_s, "queries_per_s": N_QUERIES / match_s,
        "unseen_queries": N_UNSEEN, "unseen_nomatch_rate": nomatch,
        "unseen_queries_per_s": N_UNSEEN / unseen_s, "launches": launches_match,
        "plain_rerun_verdicts_equal": plain_v == kernel_v,
    })
    if acc["No Denoising"] < MIN_CLEAN_ACCURACY:
        fail(f"clean accuracy {acc['No Denoising']} < {MIN_CLEAN_ACCURACY}")
    for k in launches:
        if launches_ingest[k] <= 0 or launches_match[k] <= 0:
            fail(f"{k} kernel did not launch in both ingest and match: "
                 f"{launches_ingest[k]}, {launches_match[k]}")
    if plain_v != kernel_v:
        fail("plain prunes on the card gave other verdicts than the kernels")


    # ---- 6. banks: the paper-shaped synthetic noise and IR pools
    t0 = time.perf_counter()
    noise_bank, ir_bank = dcase_shaped_banks(hours=BANK_HOURS, device=dev)
    torch.cuda.synchronize()
    emit({
        "phase": "banks", "seconds": time.perf_counter() - t0, "hours": BANK_HOURS,
        "noise_rows": noise_bank.num_clips, "row_length": noise_bank.row_length,
        "scenes": int(noise_bank.scene_starts.shape[0]), "irs": ir_bank.num_irs,
        "ir_length": int(ir_bank.irs.shape[1]),
        "noise_bytes": noise_bank.clips.numel() * 4, "ir_bytes": ir_bank.irs.numel() * 4,
    })

    # ---- 7. augment: the 1,024 clean crops under the 10 conditions
    K.reset_launch_counts()
    clean = torch.stack(queries)
    augmented, augment_line = {}, {}
    for cond, params in test_pipelines_parameters.items():
        fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device=dev)
        # two passes over the set: the first also grows the allocator's pool
        # and makes the cuFFT plans; the rate is the second's
        _, first_s = augment_condition(fp, clean)
        augmented[cond], seconds = augment_condition(fp, clean)
        augment_line[cond] = {
            "first_pass_seconds": first_s, "seconds": seconds,
            "examples_per_s": N_QUERIES / seconds,
            "peak_err": check_augmented(cond, fp, clean, augmented[cond]),
        }
        if cond.startswith("bn_"):
            snr = achieved_snr(fp, clean[:AUGMENT_BATCH], augmented[cond][:AUGMENT_BATCH])
            augment_line[cond]["snr"] = snr
            if not snr["max_err_db"] <= MAX_SNR_ERR_DB:
                fail(f"{cond}: the mix is {snr['max_err_db']} dB away from the drawn SNR")
    emit({"phase": "augment", "examples": N_QUERIES, "batch": AUGMENT_BATCH,
          "seed": AUGMENT_SEED, "conditions": augment_line})

    # the chain's variants on one batch under default_parameters, the card
    # against the CPU on the same draws, the stages and the two conv routes
    default = test_pipelines_parameters["default_parameters"]
    x256 = clean[:AUGMENT_BATCH]
    variants = {}
    for label, kw in (("fast_fused", {}), ("fast_unfused", {"fuse_lti": False}),
                      ("exact", {"fast_chain": False})):
        fp = AugmentFP(noise_bank, SR, parameters=default, impulse_response_dir=ir_bank,
                       device=dev, **kw)
        draws = fp.draw_indexed(range(AUGMENT_BATCH), x256.shape[-1], AUGMENT_SEED)
        variants[label] = {
            "apply_ms": wall_ms(lambda: fp.apply(x256, draws), 5),
            "draw_and_apply_ms": wall_ms(
                lambda: fp.batch_augment_indexed(x256, range(AUGMENT_BATCH), AUGMENT_SEED), 5),
        }
        if label == "fast_unfused":
            stages = stage_times(fp, x256)
    on_card = AugmentFP(noise_bank, SR, parameters=default, impulse_response_dir=ir_bank, device=dev)
    on_cpu = AugmentFP(noise_bank, SR, parameters=default, impulse_response_dir=ir_bank, device="cpu")
    draws16 = on_card.draw_indexed(range(16), clean.shape[-1], AUGMENT_SEED)
    card_vs_cpu = float(
        (on_card.apply(clean[:16], draws16).cpu() - on_cpu.apply(clean[:16].cpu(), draws16)).abs().max())
    emit({"phase": "augment_detail", "parameters": "default_parameters",
          "batch": AUGMENT_BATCH, "variants": variants, "stages_ms": stages,
          "card_vs_cpu_max_abs": card_vs_cpu, "card_vs_cpu_examples": 16,
          "conv_routes": conv_routes(dev)})
    if not card_vs_cpu <= MAX_CARD_VS_CPU:
        fail(f"the chain on the card is {card_vs_cpu} away from the CPU on the same draws")
    del on_cpu

    # ---- 8. conditions: identify every condition's queries
    q_names = [names[int(t)] for t in q_ids]
    accuracy = {"cleans": {"accuracy": acc["No Denoising"], "queries_per_s": N_QUERIES / match_s}}
    for cond, out in augmented.items():
        t0 = time.perf_counter()
        got = compute_accuracy_batched(
            list(out), ht, analyzer, batch_size=QUERY_BATCH, shifts=SHIFTS,
            device_matcher=dm, names=q_names, device=dev,
        )
        accuracy[cond] = {"accuracy": got["No Denoising"],
                          "queries_per_s": N_QUERIES / (time.perf_counter() - t0)}
    launches_conditions = dict(K.LAUNCHES)
    emit({"phase": "conditions", "queries": N_QUERIES, "shifts": SHIFTS,
          "conditions": accuracy, "launches": launches_conditions})
    for cond, floor in MIN_ACCURACY.items():
        if accuracy[cond]["accuracy"] < floor:
            fail(f"{cond} accuracy {accuracy[cond]['accuracy']} < {floor}")
    if accuracy["bn_m10"]["accuracy"] > accuracy["bn_p10"]["accuracy"]:
        fail("more noise (bn_m10) identified better than less (bn_p10)")
    for k, n in launches_conditions.items():
        if n <= 0:
            fail(f"{k} kernel did not launch while the conditions were identified")
    aug_default = augmented["default_parameters"][:DENOISED_QUERIES].clone()
    del augmented

    # ---- 9. where the time goes: one match batch, one ingest batch, one
    # batch_augment call
    emit(profile_call("match_waveforms, 128 queries, 4 shifts",
                      lambda: dm.match_waveforms(q_batch, shifts=SHIFTS)))
    scratch = HashTable()
    ing_names = names[:INGEST_BATCH]
    emit(profile_call("ingest_batch, 64 tracks",
                      lambda: analyzer.ingest_batch(scratch, ing_names, ing, valid_samples=valid)))
    t0 = time.perf_counter()
    hashes = analyzer.hashes_batch(ing, shifts=1, valid_samples=valid)
    t1 = time.perf_counter()
    for n, h in zip(ing_names, hashes):
        scratch.store(n, h)
    t2 = time.perf_counter()
    emit({"phase": "profile", "call": "ingest_batch split, 64 tracks",
          "hashes_batch_ms": (t1 - t0) * 1e3, "host_store_ms": (t2 - t1) * 1e3})
    emit(profile_call("batch_augment, 256 x 8 s, default_parameters",
                      lambda: on_card.batch_augment(x256)))

    # ---- 10. the UNet at full width, three precisions, card against CPU
    unet_phase(dev, P.spectrogram_frontend(aug_default[:UNET_BATCH]))

    # ---- 11. denoised: both analyzers through compute_accuracy_batched
    hook = unet_denoiser(make_identity_unet(UNet(1, 1)).to(dev))
    analyzer_den = AudfprintPeaks(
        afp_settings["audfprint"], denoising=True, denoising_model="unet",
        spec_denoiser=hook, device=dev,
    )
    aug_batch = aug_default[:QUERY_BATCH]
    # one batch's masks with and without the hook (also warms cuDNN up)
    masks_plain = P.find_peaks_batch(aug_batch)
    masks_den = P.find_peaks_batch(aug_batch, denoiser=hook)
    agreement = float((masks_plain == masks_den).float().mean())
    dm.match_waveforms(aug_batch, shifts=SHIFTS, denoiser=hook)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    den_names = q_names[:DENOISED_QUERIES]
    denoised = {}
    for label, qs in (("cleans", queries[:DENOISED_QUERIES]),
                      ("default_parameters", list(aug_default))):
        t0 = time.perf_counter()
        got = compute_accuracy_batched(
            qs, ht, analyzer, analyzer_den, batch_size=QUERY_BATCH, shifts=SHIFTS,
            device_matcher=dm, names=den_names, device=dev,
        )
        denoised[label] = {"accuracy": got,
                           "queries_per_s": DENOISED_QUERIES / (time.perf_counter() - t0)}
    launches_denoised = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    arm = compute_accuracy_batched(
        list(aug_default), ht, analyzer_den, batch_size=QUERY_BATCH, shifts=SHIFTS,
        device_matcher=dm, names=den_names, device=dev,
    )
    arm_qps = DENOISED_QUERIES / (time.perf_counter() - t0)
    emit({"phase": "denoised", "queries": DENOISED_QUERIES, "shifts": SHIFTS,
          "unet": "base=64, identity weights", "sets": denoised,
          "denoised_arm_alone_queries_per_s": arm_qps,
          "denoised_arm_alone_accuracy": arm["No Denoising"],
          "undenoised_queries_per_s": N_QUERIES / match_s,
          "mask_agreement": agreement, "mask_peaks": int(masks_plain.sum()),
          "launches": launches_denoised})
    for label, row in denoised.items():
        a = row["accuracy"]
        if set(a) != {"No Denoising", "With Denoising", "Mix Pipeline"}:
            fail(f"{label}: compute_accuracy_batched returned {sorted(a)}")
        if abs(a["With Denoising"] - a["No Denoising"]) > ACCURACY_SLACK:
            fail(f"{label}: the identity denoiser moved the accuracy: {a}")
        if a["Mix Pipeline"] < max(a["No Denoising"], a["With Denoising"]) - ACCURACY_SLACK:
            fail(f"{label}: the mix pipeline is below its arms: {a}")
    if agreement < MIN_MASK_AGREEMENT:
        fail(f"masks with and without the identity denoiser agree in {agreement} of cells")
    for k, n in launches_denoised.items():
        if n <= 0:
            fail(f"{k} kernel did not launch in the denoised accuracies")

    # ---- 12. peak metrics of the same degraded queries against their cleans
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    os.mkdir(os.path.join(tmp, "cleans"))
    os.mkdir(os.path.join(tmp, "default_parameters"))
    q_paths = []
    for i in range(DENOISED_QUERIES):
        np.save(os.path.join(tmp, "cleans", f"q{i:04d}.npy"), queries[i].cpu().numpy())
        q_paths.append(os.path.join(tmp, "default_parameters", f"q{i:04d}.npy"))
        np.save(q_paths[-1], aug_default[i].cpu().numpy())
    K.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = compute_peaks_metrics_batched(
        q_paths, analyzer, analyzer_den, cleans_path=os.path.join(tmp, "cleans"))
    metrics_s = time.perf_counter() - t0
    launches_metrics = dict(K.LAUNCHES)
    emit({"phase": "peaks_metrics", "queries": DENOISED_QUERIES, "metrics": metrics,
          "seconds": metrics_s, "queries_per_s": DENOISED_QUERIES / metrics_s,
          "launches": launches_metrics})
    if set(metrics) != set(PEAKS_METRICS) or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"peak metrics missing or not finite: {metrics}")
    if abs(metrics["f1_den"] - metrics["f1_score_no_den"]) > MAX_F1_GAP:
        fail(f"the identity denoiser moved the peak F1: {metrics}")
    if abs(metrics["psnr_den_spec"] - metrics["psnr_no_den_spec"]) > MAX_PSNR_GAP_DB:
        fail(f"the identity denoiser moved the spectrogram PSNR: {metrics}")
    for k, n in launches_metrics.items():
        if n <= 0:
            fail(f"{k} kernel did not launch in the peak metrics")

    # ---- 9 again: where the time of a denoised match batch goes
    emit(profile_call("match_waveforms with the UNet, 128 queries, 4 shifts",
                      lambda: dm.match_waveforms(aug_batch, shifts=SHIFTS, denoiser=hook)))
    del hook, analyzer_den, masks_plain, masks_den
    torch.cuda.empty_cache()

    # ---- 13-15. training: one step card against CPU, the published UNet
    # trained in two precisions with a resume, then the trained checkpoint
    # as the denoiser of phases 11 and 12
    train_step_check(dev)
    ckpt_dir = tempfile.TemporaryDirectory()
    ckpt_path = train_phase(dev, noise_bank, ir_bank, ckpt_dir.name)
    trained = trained_denoiser_phase(
        dev, ckpt_path, ht, dm, analyzer, queries, aug_default, den_names, q_paths,
        os.path.join(tmp, "cleans"))
    launches_trained = trained["launches"]
    ckpt_dir.cleanup()
    tmp_dir.cleanup()

    kernels = []
    for kname, line in (("forward_prune", 60), ("backward_prune", 113)):
        q, i, st = at_query[kname], at_ingest[kname], at_stacked[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "musicfpaugment_torch/csrc/peaks_prune.cu",
            "replaces": f"musicfpaugment_tpu/afp/audfprint/peaks_pallas.py:{line}",
            "launches": launches[kname] + launches_conditions[kname]
            + launches_denoised[kname] + launches_metrics[kname] + launches_trained[kname],
            "launches_ingest": launches_ingest[kname],
            "launches_match": launches_match[kname],
            "launches_conditions": launches_conditions[kname],
            "launches_denoised": launches_denoised[kname],
            "launches_peaks_metrics": launches_metrics[kname],
            "launches_trained_denoiser": launches_trained[kname],
            "max_abs_err": max(q["max_abs_err"], i["max_abs_err"], st["max_abs_err"]),
            "ms": st["kernel_ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": None, "shape": "stacked",
            "kernel_ms": st["kernel_ms"], "wrapper_ms": st["ms"],
            "query_kernel_ms": q["kernel_ms"], "query_wrapper_ms": q["ms"],
            "query_plain_ms": q["plain_ms"], "query_bound_ms": q["bound_ms"],
            "ingest_kernel_ms": i["kernel_ms"], "ingest_wrapper_ms": i["ms"],
            "ingest_plain_ms": i["plain_ms"], "ingest_bound_ms": i["bound_ms"],
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    main()

"""Card check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port end to end on the card through the entry points a user
calls, and fails (exit 1, the reason on standard error) where the card
disagrees with the CPU, a kernel with its plain version, a path with its
oracle, or a result with its floor. It times nothing but the kernels of the
kernel table: the benchmark (``portbench/``, ``BENCHMARK.json``) and the
ledger (``PERF_LEDGER.jsonl``) hold the rates, times and profiles. Its phases
and what each checks:

1. device  - the card's name and power limit (printed);
2. build   - compiles the CUDA kernels from ``musicfpaugment_torch/csrc``;
2a. prng   - the threefry functions of ``core/prng.py`` on the card against
             the CPU, 2^20 draws each: ``split``, ``fold_in``, ``uniform``,
             ``randint`` and ``bernoulli`` with 0 mismatching words,
             ``normal`` within 2 ulp;
2b. corpus_card_vs_cpu - 64 tracks of the scale corpus (30 s, seed 1234)
             built on the card and on the CPU: within 1e-5 of the peak;
3. kernels - each prune kernel against its plain PyTorch version on the same
             card tensors, at the shapes the path gives it (a 128-query
             batch of 8 s crops; the 512 rows of that batch's 4 stacked
             shifts, 251 and 250 columns; a 64-track ingest batch of
             20-30 s tracks, mixed lengths; a 128-track batch of the
             reference-scale ingest, 30 s, 938 columns): 0 mismatching
             cells; the kernel table's times and bounds;
3a. flax_init_dropout - the fused dropout kernel
             (``csrc/dropout_threefry.cu``) against its plain version at the
             five sites of the training shape (128 x 3 s, base 64: 203.4M
             elements), forward and backward, float32 and bfloat16: 0
             mismatching elements (and the kernel table's times); two
             bfloat16 train steps, 10 launches a step; a rate-0.05
             ``Trainer`` step on the card and on the CPU, each from its own
             ``flax_init``: loss within 1e-5;
3b. hash_stage - the matcher's hashing kernel (``csrc/union_hashes.cu``)
             against its plain version (``landmarks.union_hashes_plain``) on
             the same card masks: the prunes' masks of the 128-query batch
             in its 4 shifts (251 and 250 columns) and of 128 30 s tracks in
             4 shifts (938 and 937), both at the matcher's budget of 4,096,
             and of the first ingest batch (64 mixed-length 20-30 s tracks
             with their valid lengths, 1 shift) at the budget
             ``hashes_batch`` gives it, which truncates nothing: one launch
             a call, 0 mismatching rows (and the kernel table's times and
             bound);
3c. rope_qk - BS-RoFormer's rotary kernel (``csrc/rope_qk.cu``) against
             ``RotaryEmbedding.rotate`` on q and k of the same card QKV
             projection at the ``bsroformer384-identify`` cell's two
             shapes (7,936 time sequences of 146 frames, 18,688 band
             sequences of 62 bands, 8 heads of 64): one launch a call, 0
             mismatching elements (and the kernel table's times and bound);
4. ingest  - 10,000 synthetic 20-30 s tracks, generated on the card, indexed
             by ``create_fp_database`` into a full 2^20 x 100 ``HashTable``
             holding every track; the hashing kernel once an ingest batch;
5. match   - ``compute_accuracy_batched`` (batch 128, 4 shifts) over 1,024
             clean 8 s crops of indexed tracks: accuracy >= 0.99; 128 crops
             of tracks never indexed; one batch re-run with the plain prunes
             on the card: the same verdicts, no kernel launched;
6. banks   - ``dcase_shaped_banks()`` at its defaults (3 h of noise in 15
             scenes, 271 impulse responses), built on the host and put on
             the card;
7. augment - ``AugmentFP`` with ``freeze_parameters(42)`` and
             ``batch_augment_indexed`` (batch 256) over the same 1,024 clean
             crops under each of the paper's 10 conditions: every output
             finite with peak 1, a zero input staying zero; the achieved SNR
             of the noise-only conditions' first batch within 0.2 dB of the
             drawn one; one batch of 16 against the same draws on the CPU
             (at most 1e-5 apart); the filters' direct convolution with
             cuDNN on;
7a. queries_card_vs_cpu - the scale proof's first 64 frozen-seed-42
             ``default_parameters`` queries (plan, crops of the corpus,
             augmentation with the phase 6 banks) on the card and on the
             CPU: within 1e-4;
8. conditions - ``compute_accuracy_batched`` on each condition's augmented
             queries with the ``DeviceMatcher`` of phase 5: ``bn_p10`` and
             ``recording_device`` >= 0.95, ``bn_m10`` no better than
             ``bn_p10``;
10. unet   - ``UNet(1, 1)`` at ``base=64`` with weights from a numpy seed on
             degraded queries' spectrograms in strict float32: finite, and
             the card within 1e-3 of the largest output from the CPU on 2;
11. denoised - a ``base=64`` UNet whose weights make it the identity on
             non-negative input as the second analyzer's spectrogram
             denoiser: ``compute_accuracy_batched`` with both analyzers over
             the first 256 clean and the first 256 ``default_parameters``
             queries (batch 128, 4 shifts): the three accuracies, "With
             Denoising" within 2/256 of "No Denoising", "Mix Pipeline" no
             lower than either less 2/256; one batch's peak masks with and
             without the hook equal in >= 0.999 of cells;
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
             Flax's initial weights (the trainer draws them), dropout
             through the kernel: every loss and PSNR finite, the validation
             loss falling from the first epoch to the last; then a resume
             from the float32 run's ``last_epoch``: its metadata's keys, one
             more epoch from the saved step, a finite loss;
15. trained_denoiser - phases 11 and 12 again with the float32 run's best
             checkpoint as the denoiser: the three accuracies, eight finite
             peak metrics;
16. demucs - the published ``Demucs()`` (hidden 48, depth 5, x4 resampling,
             causal LSTM of width 768) with seeded weights (PyTorch's
             initialisation, then ``rescale_params(0.1)``) on degraded 8 s
             queries in strict float32: finite, the card within 1e-4 of the
             largest output from the CPU on 2 clips, its cuDNN LSTM within
             1e-4 of float64 on the same operands;
17. demucs_denoised - phase 11 with ``demucs_denoiser`` as the second
             analyzer's waveform hook: the three accuracies over 2 x 256
             queries; the denoised arm alone, its verdicts equal to the plain
             matcher's on batches denoised beforehand and the hook called
             once per batch; the eight peak metrics finite;
18. demucs_train_step_check - one "audio" step of ``Demucs(hidden=8,
             depth=3)`` card against CPU: loss terms 1e-5 (relative), float64
             gradients 1e-4;
19. demucs_train - the published Demucs trained as phase 14 (lr 5e-4, the
             "audio" losses) in strict float32 and in bfloat16: the same
             loss checks;
20. demucs_denoised again with the float32 run's best checkpoint;
21. streamer - ``DemucsStreamer`` over the seeded Demucs, 10 s at 8 kHz
             frame by frame: delta to the offline forward under 5%,
             real-time factor under 1;
22. dejavu_ingest - Dejavu at the paper's settings (8 kHz, n_fft 512, hop
             256, fan 3, amp_min 50, neighbourhood 10): the 10,000 tracks,
             each cut to whole seconds and batched by length (256 a batch),
             through ``DejavuDeviceIndex.ingest_arrays``, ``finalize`` and
             the matcher's upload;
23. dejavu_match - ``recognize_waveforms`` over the 1,024 clean crops in
             batches of 128: accuracy >= 0.99 (the 128 unseen crops' NOMATCH
             rate is printed, not held);
24. dejavu_conditions - phase 7's augmented queries of each condition
             (printed);
25. dejavu_oracle - 256 tracks and 128 queries (64 clean, 64
             ``default_parameters``): one set of card masks fed to the host
             path (SHA1 hashes, SQLite, ``align_matches``) and to the device
             path (``pack_hashes_from_masks``, ``_dejavu_match_impl``):
             every field of every verdict equal;
26. dejavu_card_vs_cpu - one batch of 128 against the same index on the
             card and on the CPU: masks equal in >= 0.999 of cells, >= 126
             verdict songs equal, the match of the same hashes
             bit-identical;
27. dejavu_denoised - the seeded ``base=64`` UNet as a second matcher's
             spectrogram hook through ``compute_accuracy_batched`` over 2 x
             256 queries (the three accuracies; card against CPU on 16
             queries, masks >= 0.999 of cells), and the seeded published
             Demucs through the per-file ``compute_accuracy`` on 32 of phase
             25's queries over its SQLite corpus (the three accuracies);
28. dejavu_peaks_metrics - ``compute_peaks_metrics_batched`` over phase
             12's 256 ``.npy`` pairs with each arm: eight finite numbers.
             The Dejavu path reaches no prune kernel: the launch counts
             must not move across phases 22-28.
30. native_io - the g++ build of ``native/*.cc`` must build and load;
             whether libmpg123 and libmp3lame load (printed);
31. fma_eval - an FMA tree in a temporary directory: ``tracks.csv`` in
             FMA's layout (16 genres x 512 tracks of 30 s), every track's
             path as the path list, and the first 256 selected tracks written
             as 30 s synthetic files at 22.05 kHz (mp3; WAV where a codec is
             missing; the selection must keep all but the six exceptions,
             ``read_wav_batch`` must decode every file); then through the
             entry points the preprocessing ``main``, ``audfprint_exps.main(
             ["--action", "index"])`` into a full 2^20 x 100 table,
             ``dejavu_exps.main(["--action", "index"])`` into SQLite (no
             prune launch), ``generate_queries.main(["--queries", "cleans",
             "--save"])`` (absent files skipped): every file indexed by both
             systems and queried, the saved clean queries identified by both
             (accuracy >= 0.99); prune and hashing counters zeroed before the
             index and the identification, each kernel launched in each;
32. parallel - an NCCL group of world size 1: the published UNet trained 3
             steps with and without ``DistributedDataParallel`` from one seed
             (losses within 1e-6), ``ShardedAugmenter`` over ``[cuda:0,
             cuda:0]`` against ``apply`` on the whole batch and both matchers
             on that mesh against one card (256 queries): bit for bit;
33. monitoring - the train phase's float32 checkpoint resumed with
             ``monitoring``: ``_log_tensorboard`` and ``_log_media`` through a
             ``SummaryWriter`` (a recording writer without tensorboard; nine
             finite images at most 1, three scalars or more), the CQT loss at
             128 x 3 s (finite; card against CPU 1e-5) and
             ``generate_audios.main`` on the checkpoint (its wavs written);
34. app     - the demo app's ``define_model`` with a stand-in panel and
             ``process_audio`` of 4 x 8 s at 16 kHz on the card: four wavs
             at 16 kHz, finite, peak <= 1;
35. scale_ingest - ``testing/scale_proof``'s ``ingest`` stage over 106,574
             storage-free 30 s tracks (FMA-large's size, generated on the
             card) into a full 2^20 x 100 table, in two invocations (the
             first stopped by ``--minutes``, the second resuming from the
             saved table and state): done, the table saturated, no track
             overflowing;
36. scale_match - its ``match`` stage, 512 queries x 11 conditions, 4
             shifts, ``--banks dcase`` (clean accuracy >= 0.99); then
             ``train`` cut to 2 epochs x 4 steps and the UNet arm with the mix
             rule over 128 queries of ``cleans`` and ``default_parameters``
             (clean mix accuracy >= 0.99), and the same for Demucs over 128
             queries of ``bn_m10``: each arm's accuracies in [0, 1];
37. scale_oracle - its ``oracle`` stage, 32 queries at 4 shifts: 32/32;
38. scale_peaks - its ``peaks`` stage over 256 queries of each condition
             (finite), then its ``report``;
39-41. dejavu_scale_ingest / _match / _oracle - ``testing/dejavu_scale`` on
             the same corpus at the hash cap 1,024 (one load and finalize,
             whose CSR the match, the UNet arm and the oracle share): 512
             queries x 11 conditions (clean >= 0.99) and the UNet arm over
             128; the Python ``align_matches`` oracle 32/32; no prune launch;
41a. cap_sweep - ``testing/dejavu_cap_sweep``: a 10,000-track ingest with
             no cap, re-finalized under the caps 64, 1,024 and none, 512
             queries x ``cleans,default_parameters`` under each: rows dropped
             falling with the cap, none uncapped, uncapped clean accuracy
             >= 0.99;
42. full_pipeline_demo - ``testing/full_pipeline_demo`` at its quick size
             (16 tracks, 2 epochs, 16 queries): clean accuracy >= 0.99;
44. big_bank - ``train/big_bank_train``: the base=8 UNet step, batch 32 x 3 s,
             with a 256 MB noise bank against the 32-row toy bank: the big
             bank's MB allocated per step within a tenth of its size of the
             toy bank's (it is not copied per step).

Every phase prints a JSON line. Launch counters: the prune counters are
zeroed just before the ingest and read after the match: both prune kernels
must have launched in each (once per ingest batch, once per match batch
whatever the number of shifts). They are zeroed again before the augmented
conditions, the denoised accuracies, the peak metrics, the trained-denoiser
runs, each Demucs-denoised run, the FMA index, the FMA identification, the
mesh match and each scale path (the ingest's two invocations, the match,
each denoised arm, the oracle, the peaks, the demo), and read after each:
each kernel must have launched. The dropout kernel's counter is zeroed just
before and read just after each path that trains a UNet (phase 14's
training, the parallel phase's steps, the scale proof's UNet ``train``
stage, the demo, the big-bank step): it must have launched in each. The
hashing kernel's counter is zeroed before the ingest, the match, the
conditions, the denoised accuracies, the trained-denoiser runs, each
Demucs-denoised run, the FMA index, the FMA identification, the mesh match
and each scale path, and read after those that hash: it must read one
launch an ingest batch (ingest) or a ``match_waveforms`` call a device
where the calls are counted here (match, conditions, denoised, trained
denoiser, Demucs, mesh), and above 0 in the FMA index and identification
and the scale match and denoised arms.
The line before the last is the kernel table, the last line is
``{"ok": true, "device": {...}}``.

In the kernel table ``ms``, ``plain_ms`` and ``bound_ms`` are those of the
shape the match path launches (512 stacked rows), ``ms`` the launch on the
time-major tensors as the path calls it and ``wrapper_ms`` the (B, F, C)
wrapper with its transposed copies; ``query_*``, ``ingest_*`` and
``scale_ingest_*`` are the same readings at the other three shapes.
The ``union_hashes`` entry's ``ms``, ``bound_ms`` and ``library_ms`` (the
PyTorch chain, which is also its plain version) are phase 3b's at the query
shape, ``long_30s_*`` at 30 s, ``ingest_*`` at the ingest batch, and
``launches_*`` the counts above.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import copy
import functools
import glob
import io
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from musicfpaugment_torch import _build
from musicfpaugment_torch.afp.audfprint import DeviceMatcher, HashTable
from musicfpaugment_torch.afp.audfprint import hashes_cuda as HC
from musicfpaugment_torch.afp.audfprint import peaks as P
from musicfpaugment_torch.afp.audfprint import peaks_cuda as K
from musicfpaugment_torch.afp.audfprint.analyzer import (
    AudfprintPeaks,
    pad_waveform_batch,
    valid_frames_for,
)
from musicfpaugment_torch.afp.dejavu import (
    Dejavu,
    DejavuDeviceIndex,
    DejavuDeviceMatcher,
    SQLiteDatabase,
    fingerprint_spectrogram_batch,
    generate_hashes,
    pack_hashes_from_masks,
)
from musicfpaugment_torch.afp.dejavu.fingerprint import peaks_from_mask
from musicfpaugment_torch.afp.dejavu.matcher_device import _dejavu_match_impl as dj_match_impl
from musicfpaugment_torch.apps import streamlit_app
from musicfpaugment_torch.augment import AugmentFP, dcase_shaped_banks
from musicfpaugment_torch.convert import demucs_denoiser, unet_denoiser
from musicfpaugment_torch.core import filters, prng
from musicfpaugment_torch.data import mp3_encode, native
from musicfpaugment_torch.data.synthetic import (
    synth_tracks_device,
    synthetic_clean_batches,
    write_fma_tracks_csv,
)
from musicfpaugment_torch.device import cudnn_tf32
from musicfpaugment_torch.models import Demucs, UNet, rescale_params
from musicfpaugment_torch.models import dropout as DROP
from musicfpaugment_torch.models.streamer import DemucsStreamer
from musicfpaugment_torch.parallel import ShardedAugmenter, init_multihost
from musicfpaugment_torch.testing import audfprint_exps, fma_preprocessing, generate_queries
from musicfpaugment_torch.testing import dejavu_cap_sweep as CS
from musicfpaugment_torch.testing import dejavu_scale as DS
from musicfpaugment_torch.testing import full_pipeline_demo
from musicfpaugment_torch.testing import scale_proof as SP
from musicfpaugment_torch.testing import dejavu_exps as dj_exps
from musicfpaugment_torch.testing.audfprint_exps import (
    PEAKS_METRICS,
    compute_accuracy_batched,
    compute_peaks_metrics_batched,
    create_fp_database,
)
from musicfpaugment_torch.testing.parameters import (
    afp_db_paths,
    afp_settings,
    queries_paths,
    test_pipelines_parameters,
)
from musicfpaugment_torch.train import big_bank_train, cqt, generate_audios
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

# Demucs: the published model with the port's own seeded initialisation
DEMUCS_SEED = 48
DEMUCS_BATCH = 128
DEMUCS_CPU_EXAMPLES = 2
# relative to the largest output: float32 rounding through the 10
# convolution stages and 2 x 249 LSTM steps reads ~1e-6, TF32 ~1e-3
MAX_DEMUCS_CARD_VS_CPU = 1e-4
MAX_LSTM_STRICT_REL = 1e-4
DEMUCS_TRAIN_LR = 5e-4  # the JAX CLI's for Demucs
STREAM_SECONDS = 10
MAX_STREAM_DELTA = 0.05  # the JAX package's own limit

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj) -> None:
    """One JSON line."""
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


def check_kernels(name, x, vf):
    """Kernel vs plain on the same card tensors at one path shape: 0
    mismatching cells required. ``ms`` times the (B, F, C) wrapper (the
    transposed copies and the launch), ``kernel_ms`` the launch alone on the
    time-major tensors, as the path calls it."""
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
        out[kname] = {
            "shape": name, "B": x.shape[0], "F": x.shape[1], "C": x.shape[2],
            "mismatch": mism, "ms": gpu_ms(kfn, 20), "kernel_ms": gpu_ms(tmfn, 20),
            "plain_ms": gpu_ms(pfn, 2), "bound_ms": b_ms, "bound_by": b_by,
        }
        if mism:
            fail(f"{kname} at the {name} shape disagrees with its plain version "
                 f"in {mism} cells")
    return out


def hash_stage_check(dev, shapes: dict) -> dict:
    """The hashing kernel against the plain chain on the same card masks at
    each shape (``{name: (waves, shifts, budget, valid_samples)}``; a budget
    of None is the one ``hashes_batch`` gives, which truncates nothing): 0
    mismatching rows required. ``bound_ms`` is the masks' bytes read once
    and the output's written once at the card's byte rate; ``library_ms``
    the plain chain (PyTorch ops) on the card."""
    from musicfpaugment_torch.afp.audfprint import landmarks as lm

    out = {}
    for name, (waves, shifts, budget, valid_samples) in shapes.items():
        vsamp = None
        if valid_samples is not None:
            vsamp = torch.as_tensor(np.asarray(valid_samples, np.int32), device=dev)
        masks = P.find_peaks_shifts(waves, shifts, valid_samples=vsamp)
        cols = [int(m.shape[-1]) for m in masks]
        B, F = int(masks[0].shape[0]), int(masks[0].shape[1])
        max_peaks = [lm.shift_max_peaks(c, 5) for c in cols]
        if budget is None:
            budget = lm.MAXPAIRSPERPEAK * sum(max_peaks)
        launches = HC.LAUNCHES["union_hashes"]
        got = lm.union_hashes(masks, 5, budget)
        want = lm.union_hashes_plain(masks, 5, budget)
        torch.cuda.synchronize()
        if HC.LAUNCHES["union_hashes"] != launches + 1:
            fail(f"union_hashes did not launch its kernel once at the {name} shape")
        rows = (got[0] != want[0]).any(1) | (got[1] != want[1]).any(1) | (got[2] != want[2])
        mism = int(rows.sum())
        out_len = int(got[0].shape[1])
        nbytes = B * sum(cols) * F + 2 * B * out_len * 4 + B * 8
        out[name] = {
            "B": B, "F": F, "shifts": shifts, "cols": cols, "out_len": out_len,
            "mismatch_rows": mism,
            "kernel_ms": gpu_ms(lambda: HC.union_hashes_cuda(masks, max_peaks, budget), 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "library_ms": gpu_ms(lambda: lm.union_hashes_plain(masks, 5, budget), 20),
        }
        if mism:
            fail(f"union_hashes at the {name} shape disagrees with its plain version "
                 f"in {mism} of {B} rows")
    return out


def rope_check(dev) -> dict:
    """The rotary kernel against the plain chain (``rotate`` on the
    projection's q and k views) on the same card tensors at the
    BS-RoFormer cell's two shapes: 0 mismatching elements required.
    ``bound_ms`` is q and k read once and written once, and the two tables
    read, at the card's byte rate."""
    from musicfpaugment_torch.models import bs_roformer as BR

    heads, width = 8, BR.ROPE_KERNEL_DIM
    out = {}
    for name, S, n in (("time", 7936, 146), ("band", 18688, 62)):
        rope = BR.RotaryEmbedding(width)
        gen = torch.Generator(device=dev).manual_seed(n)
        qkv = torch.randn(S, n, 3 * heads * width, device=dev, generator=gen)
        view = qkv.view(S, n, 3, heads, width).permute(2, 0, 3, 1, 4)
        launches = BR.LAUNCHES["rope_qk"]
        q, k = rope.rotate_qk(qkv, heads)
        mism = int((q != rope.rotate(view[0])).sum()) + int((k != rope.rotate(view[1])).sum())
        torch.cuda.synchronize()
        if BR.LAUNCHES["rope_qk"] != launches + 1:
            fail(f"rotate_qk did not launch its kernel once at the {name} shape")
        nbytes = 4 * 2 * (q.numel() + k.numel()) + 4 * 2 * n * width
        del q, k
        out[name] = {
            "S": S, "n": n, "heads": heads, "mismatch": mism,
            "kernel_ms": gpu_ms(lambda: rope.rotate_qk(qkv, heads), 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
            "plain_ms": gpu_ms(lambda: (rope.rotate(view[0]), rope.rotate(view[1])), 20),
        }
        if mism:
            fail(f"rope_qk at the {name} shape disagrees with its plain version "
                 f"in {mism} elements")
    return out


HASH_LAUNCHES: dict = {}  # phase -> launches of the hashing kernel, by hashes_counted


def hashes_counted(label: str, want=None) -> int:
    """The hashing kernel's launches since its counter was last zeroed, kept
    as ``HASH_LAUNCHES[label]``: above 0, and ``want`` where given (one a
    ``match_waveforms`` call a device)."""
    n = HASH_LAUNCHES[label] = HC.LAUNCHES["union_hashes"]
    if n <= 0 or (want is not None and n != want):
        fail(f"the hashing kernel launched {n} times in {label}"
             + ("" if want is None else f", not {want}"))
    return n


# ---------------------------------------------------------- flax_init_dropout

DROP_RATE = 0.05  # the training CLI's
# per element: 20 threefry rounds of add, rotate, xor (60), six key
# injections of two adds (12), the xor of the words, the uniform's shift, or,
# subtract and compare (5), the counter's index arithmetic (~3): ~80 32-bit
# operations, counted against the card's float32 rate (its integer rate is
# no higher)
DROP_OPS_PER_ELEMENT = 80
DROP_STEP_CPU_BASE = 8  # the card-vs-CPU Trainer step: UNet(base=8), batch 8 x 3 s


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as integers of its width (for exact comparisons)."""
    return t.contiguous().view({4: torch.int32, 2: torch.int16, 8: torch.int64}[t.element_size()])


def unet_site_shapes(dev, batch: int, spec: tuple) -> list:
    """NCHW shapes of the five dropout sites of ``UNet(base=64)`` at a
    (batch, *spec) spectrogram batch."""
    model = UNet(1, 1, rate=DROP_RATE, base=64).to(dev).eval()
    shapes = []
    hooks = [m.register_forward_hook(lambda mod, args, out: shapes.append(tuple(args[0].shape)))
             for m in model.dropouts]
    with torch.no_grad():
        model(torch.zeros((1, *spec), device=dev))
    for h in hooks:
        h.remove()
    return [(batch, *s[1:]) for s in shapes]


def flax_init_dropout_phase(dev) -> dict:
    """Phase 3a: the fused dropout kernel against its plain version on the
    same card tensors at the training shape (128 x 3 s, base 64: the five
    sites, 203.4M elements a step), forward and backward, in float32 and
    bfloat16: 0 mismatching elements; its ms, bound, the plain version's ms
    and ``F.dropout``'s (torch's Philox masks: a yardstick, other draws) for
    the kernel table; two bfloat16 train steps, 10 launches a step; one
    strict float32 ``Trainer`` step at rate 0.05 on the card and on the
    CPU, each from its own ``flax_init``: loss within 1e-5."""
    line = {"phase": "flax_init_dropout", "rate": DROP_RATE}
    # -- the kernel against its plain version at the five sites
    spec = (257, 1 + TRAIN_SAMPLES // 256)
    sites = unet_site_shapes(dev, TP.BATCH_SIZE, spec)
    k_drop = prng.split(prng.split(prng.key(59)).unbind(-2)[1]).unbind(-2)[1]
    gen = torch.Generator(device=dev).manual_seed(7)
    per_dtype = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        totals = {"ms": 0.0, "plain_ms": 0.0, "torch_dropout_ms": 0.0, "bytes": 0, "ops": 0}
        for i, shape in enumerate(sites):
            key = prng.flax_fold(k_drop, f"Dropout_{i}", 1)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
            yk = DROP.dropout_cuda(xk, key, DROP_RATE)
            yp = DROP.dropout_plain(xp, key, DROP_RATE)
            yk.backward(g)
            yp.backward(g)
            torch.cuda.synchronize()
            fwd_mism = int((_bits(yk.detach()) != _bits(yp.detach())).sum())
            bwd_mism = int((_bits(xk.grad) != _bits(xp.grad)).sum())
            del xk, xp, yk, yp, g
            totals["bytes"] += 2 * x.numel() * x.element_size()
            totals["ops"] += DROP_OPS_PER_ELEMENT * x.numel()
            totals["ms"] += gpu_ms(lambda: DROP.dropout_cuda(x, key, DROP_RATE), 20)
            totals["plain_ms"] += gpu_ms(lambda: DROP.dropout_plain(x, key, DROP_RATE), 2)
            totals["torch_dropout_ms"] += gpu_ms(
                lambda: torch.nn.functional.dropout(x, DROP_RATE), 20)
            del x
            torch.cuda.empty_cache()
            if fwd_mism or bwd_mism:
                fail(f"dropout_threefry {dname} at Dropout_{i} {list(shape)}: {fwd_mism} forward "
                     f"and {bwd_mism} backward elements differ from the plain version")
        totals["bound_ms"], totals["bound_by"] = bound(totals["bytes"], totals["ops"])
        per_dtype[dname] = totals
    line["step_forward"] = per_dtype
    # -- two bfloat16 train steps with the kernel: 10 launches a step
    clean = next(synthetic_clean_batches(TP.BATCH_SIZE, TRAIN_SAMPLES, SR, seed=UNET_SEED))
    aug = (0.7 * clean + 0.2 * np.random.default_rng(UNET_SEED).standard_normal(clean.shape)).astype(
        np.float32)
    clean_t, aug_t = torch.from_numpy(clean).to(dev), torch.from_numpy(aug).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(UNet(1, 1, rate=DROP_RATE, base=64, dtype=torch.bfloat16), iter(()), 1,
                          iter(()), 1, TRAIN_LR, 2, tmp, input_type="spec", device=dev)
    steps = 2
    DROP.reset_launch_counts()
    for _ in range(steps):
        trainer.train_step(clean_t, aug_t)
    torch.cuda.synchronize()
    launches = DROP.LAUNCHES["dropout_threefry"]
    del trainer
    torch.cuda.empty_cache()
    line["launches_per_train_step"] = launches / steps
    if launches != 10 * steps:
        fail(f"dropout_threefry launched {launches} times in {steps} steps, not 10 a step")
    # -- a Trainer step at rate 0.05, card against CPU, each from its own init
    small = next(synthetic_clean_batches(8, TRAIN_SAMPLES, SR, seed=UNET_SEED))
    small_aug = (0.7 * small + 0.2 * np.random.default_rng(1).standard_normal(small.shape)).astype(
        np.float32)
    losses = {}
    for label, device in (("cpu", "cpu"), ("card", dev)):
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(UNet(1, 1, rate=DROP_RATE, base=DROP_STEP_CPU_BASE), iter(()), 1,
                              iter(()), 1, TRAIN_LR, 2, tmp, input_type="spec", device=device)
        losses[label] = float(trainer.train_step(torch.from_numpy(small).to(device),
                                                 torch.from_numpy(small_aug).to(device))["loss"])
    rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    line["trainer_step_loss_rel"] = rel
    emit(line)
    if not rel <= MAX_STEP_LOSS_REL:
        fail(f"a rate-0.05 Trainer step on the card is {rel} (relative) from the CPU's")
    return line


def augment_condition(fp, clean):
    """``clean`` (N, T) through ``fp``'s frozen-seed chain in batches of
    AUGMENT_BATCH, example i under index i."""
    fp.freeze_parameters(AUGMENT_SEED)
    return torch.cat([
        fp.batch_augment_indexed(clean[s : s + AUGMENT_BATCH],
                                 range(s, min(s + AUGMENT_BATCH, len(clean))))
        for s in range(0, len(clean), AUGMENT_BATCH)
    ])


def check_augmented(name, fp, clean, out) -> None:
    """Finite, every row's peak 1 within 1e-6, a zero input staying zero."""
    if out.shape != clean.shape or not bool(torch.isfinite(out).all()):
        fail(f"{name}: augmented queries of shape {tuple(out.shape)} or not finite")
    peak_err = float((out.abs().amax(-1) - 1.0).abs().max())
    if peak_err > 1e-6:
        fail(f"{name}: a row's peak is {peak_err} away from 1")
    pair = torch.stack([clean[0], torch.zeros_like(clean[0])])
    if float(fp.batch_augment_indexed(pair, [0, len(clean)])[1].abs().max()) != 0.0:
        fail(f"{name}: an all-zero input did not stay zero")


def snr_error_db(fp, clean, out) -> float:
    """A noise-only condition on the card: ``out`` is a * clean + b * noise
    with the noise crop that the same draws name, so least squares on the
    pair gives the two gains and 20 log10(rms(a clean) / rms(b noise)) is
    the SNR that the mix reached. Returns its largest distance in dB from
    the one drawn."""
    n = clean.shape[0]
    draws = fp.draw_indexed(range(n), clean.shape[-1], prng.key(AUGMENT_SEED))[2]
    noise = fp.noise_bank.crop(
        draws["scene"], draws["row_u"], draws["offset"], clean.shape[-1]).double()
    x, y = clean.double(), out.double()
    xx, xn, nn = (x * x).sum(-1), (x * noise).sum(-1), (noise * noise).sum(-1)
    yx, yn = (y * x).sum(-1), (y * noise).sum(-1)
    det = xx * nn - xn * xn
    a, b = (yx * nn - yn * xn) / det, (yn * xx - yx * xn) / det
    reached = 10 * torch.log10(a * a * xx / (b * b * nn))
    return float((reached - draws["snr_db"].to(reached)).abs().max())


def check_conv_route(dev) -> None:
    """The filters' direct grouped convolution at (256, 64000) with 33 to
    513 taps must run with cuDNN on (``cudnn_enabled`` read inside the
    call)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((AUGMENT_BATCH, QUERY_SECONDS * SR), generator=g).to(dev)
    seen = []
    conv1d = filters.F.conv1d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.enabled)
        return conv1d(*args, **kwargs)

    halves = (16, 64, 128, 256)
    for half in halves:
        kernels = filters.lowpass_kernels(torch.linspace(0.05, 0.45, AUGMENT_BATCH).to(dev), half)
        filters.F.conv1d = spy
        try:
            filters._direct_conv_valid(filters._edge_pad(x, half), kernels)
        finally:
            filters.F.conv1d = conv1d
    if seen != [True] * len(halves):
        fail(f"cuDNN was off inside the filters' direct route: {seen}")


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


def unet_phase(dev, sgrams: torch.Tensor) -> dict:
    """Phase 10 on ``sgrams`` (UNET_BATCH, 257, 251), normalised magnitudes
    of degraded queries: the seeded UNet's strict float32 forward on the
    card, finite, and within 1e-3 of its largest output from the CPU's on
    2 spectrograms."""
    on_cpu = seeded_unet(UNET_SEED)
    strict_hook = unet_denoiser(copy.deepcopy(on_cpu).to(dev))
    few = sgrams[:8]
    want = strict_hook(few)
    cpu_out = unet_denoiser(on_cpu)(sgrams[:2].cpu())
    card_vs_cpu = float((want[:2].cpu() - cpu_out).abs().max()) / float(cpu_out.abs().max())
    line = {
        "phase": "unet", "base": on_cpu.base, "seed": UNET_SEED, "input": list(sgrams.shape),
        "output_finite": bool(torch.isfinite(want).all()),
        "card_vs_cpu_rel": card_vs_cpu, "card_vs_cpu_examples": 2,
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
    torch.manual_seed(UNET_SEED)
    weights = UNet(1, 1, rate=0.0, base=8).state_dict()
    for label, device, dtype in (("cpu", "cpu", torch.float32), ("card", dev, torch.float32),
                                 ("cpu64", "cpu", torch.float64), ("card64", dev, torch.float64)):
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(UNet(1, 1, rate=0.0, base=8).to(dtype), iter(()), 1, iter(()), 1,
                              TRAIN_LR, 2, tmp, input_type="spec", device=device)
        trainer.model.load_state_dict(weights)  # over the trainer's own (Flax) initial weights
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
    (loss_c, _, stats_c), (loss_g, _, stats_g) = runs["cpu"], runs["card"]
    grads_c64, grads_g64 = runs["cpu64"][1], runs["card64"][1]
    line = {
        "phase": "train_step_check", "base": 8, "batch": clean.shape[0], "samples": clean.shape[1],
        "loss_rel": abs(loss_g - loss_c) / abs(loss_c),
        "stats_rel_max": max(_rel_max(stats_g[k], stats_c[k]) for k in stats_c),
        "grad_rel_max_float64": max(_rel_max(grads_g64[k], grads_c64[k]) for k in grads_c64),
        "conv_backward_vs_float64_max": probe_err,
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


@functools.lru_cache(maxsize=None)
def training_batches():
    """(train, validation) lists of clean (128, 3 s) batches (made once, for
    both models)."""
    train = [b for b, _ in zip(synthetic_clean_batches(TP.BATCH_SIZE, TRAIN_SAMPLES, SR, seed=59),
                               range(TRAIN_STEPS))]
    val = [b for b, _ in zip(synthetic_clean_batches(TP.BATCH_SIZE, TRAIN_SAMPLES, SR, seed=4),
                             range(TRAIN_VAL_STEPS))]
    return train, val



def cycle(batches):
    while True:
        yield from batches


def run_training(trainer: Trainer, label: str) -> dict:
    """Baseline validation, then ``trainer.training_loop()``: the loss curve,
    which must be finite and whose validation loss must fall from the first
    epoch to the last."""
    baseline_loss, baseline_metrics = trainer.validation_epoch()
    trainer.training_loop()
    hist = trainer.history
    run = {
        "steps": trainer.step,
        "train_loss": [h["train"]["loss"] for h in hist],
        "val_loss": [baseline_loss["loss"]] + [h["val"]["loss"] for h in hist],
        "val_psnr": [baseline_metrics["psnr"]] + [h["metrics"]["psnr"] for h in hist],
    }
    losses = run["train_loss"] + run["val_loss"] + run["val_psnr"]
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: a loss or PSNR is not finite: {losses}")
    # from the first trained epoch: the baseline runs BatchNorm on its initial
    # running statistics (mean 0, variance 1), under which Flax's initial
    # UNet (zero biases) maps the small normalised spectrograms to ~0, an L1
    # baseline no short run beats (0.0183 against 0.1335, 0.0228)
    if not run["val_loss"][-1] < run["val_loss"][1]:
        fail(f"{label}: the validation loss did not fall over the epochs: {run['val_loss']}")
    return run


def train_phase(dev, noise_bank, ir_bank, ckpt_root: str) -> str:
    """The published UNet (base=64, rate 0.05) trained on the card with
    default_parameters augmentation inside each step, once in strict float32
    and once in bfloat16 from Flax's initial weights (the trainer's, as the
    JAX trainer's), dropout through the kernel: TRAIN_EPOCHS epochs of
    TRAIN_STEPS steps, checkpoints as ``--save`` writes them, then a resume
    from the float32 run's ``last_epoch`` and one more epoch. Returns the
    float32 run's best checkpoint path."""
    params = test_pipelines_parameters["default_parameters"]
    fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device=dev)
    train_batches, val_batches = training_batches()

    def make(dtype, ckpt, nb_epochs):
        return Trainer(
            UNet(1, 1, rate=0.05, base=64, dtype=dtype), cycle(train_batches), TRAIN_STEPS,
            cycle(val_batches), TRAIN_VAL_STEPS, TRAIN_LR, nb_epochs, ckpt, input_type="spec",
            augmenter=fp, factor_sc=TP.FACTOR_SC, factor_mag=TP.FACTOR_MAG,
            scheduler=ReduceLROnPlateau(factor=TP.FACTOR, patience=TP.PATIENCE),
            early_stopping=EarlyStopping(patience=TP.EARLY_STOP, min_delta=TP.MIN_DELTA),
            save=True, device=dev,
        )

    runs = {}
    for label, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        ckpt = os.path.join(ckpt_root, label)
        trainer = make(dtype, ckpt, TRAIN_EPOCHS + 1)
        run = runs[label] = run_training(trainer, f"train, UNet base=64 {label}")
        if label == "float32":
            meta_path = os.path.join(ckpt, "last_epoch", "trainer_meta.json")
            with open(meta_path) as f:
                meta = json.load(f)
            del trainer
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
            del trainer
        torch.cuda.empty_cache()
    emit({
        "phase": "train", "model": "UNet(1, 1, rate=0.05, base=64)", "batch": TP.BATCH_SIZE,
        "samples": TRAIN_SAMPLES, "augmentation": "default_parameters, dcase_shaped_banks()",
        "lr": TRAIN_LR, "epochs": TRAIN_EPOCHS, "steps_per_epoch": TRAIN_STEPS,
        "val_steps": TRAIN_VAL_STEPS, "runs": runs,
    })
    return os.path.join(ckpt_root, "float32", "best_epoch", "state.pt")


def trained_denoiser_phase(dev, ckpt_path, ht, dm, analyzer, queries, aug_default, q_names,
                           q_paths, cleans_dir) -> dict:
    """The denoised and peak-metric runs of phases 11 and 12 with the strict
    float32 checkpoint of the train phase in place of the identity weights:
    the three accuracies of each set and eight finite peak metrics."""
    state = torch.load(ckpt_path, map_location=dev, weights_only=True)["model"]
    strict = UNet(1, 1).to(dev)
    strict.load_state_dict(state)
    den = AudfprintPeaks(afp_settings["audfprint"], denoising=True, denoising_model="unet",
                         spec_denoiser=unet_denoiser(strict), device=dev)
    K.reset_launch_counts()
    HC.reset_launch_counts()
    sets = {}
    for name, qs in (("cleans", queries[:DENOISED_QUERIES]), ("default_parameters", list(aug_default))):
        sets[name] = compute_accuracy_batched(qs, ht, analyzer, den, batch_size=QUERY_BATCH,
                                              shifts=SHIFTS, device_matcher=dm, names=q_names,
                                              device=dev)
    metrics = compute_peaks_metrics_batched(q_paths, analyzer, den, cleans_path=cleans_dir)
    launches = dict(K.LAUNCHES)
    # 2 sets x 2 arms of DENOISED_QUERIES
    hashes_counted("trained_denoiser", 2 * 2 * (DENOISED_QUERIES // QUERY_BATCH))
    line = {"phase": "trained_denoiser", "checkpoint": "train phase, float32, best_epoch",
            "queries": DENOISED_QUERIES, "shifts": SHIFTS, "accuracy": sets,
            "peaks_metrics": metrics, "launches": launches}
    emit(line)
    if set(metrics) != set(PEAKS_METRICS) or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"trained denoiser: peak metrics missing or not finite: {metrics}")
    for name, acc in sets.items():
        if set(acc) != {"No Denoising", "With Denoising", "Mix Pipeline"}:
            fail(f"trained denoiser {name}: accuracies {sorted(acc)}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"{k} kernel did not launch in the trained-denoiser runs")
    return line

# ------------------------------------------------------------------ Demucs


def seeded_demucs(seed: int, **kwargs) -> Demucs:
    """A Demucs on the CPU with PyTorch's default initialisation under
    ``torch.manual_seed(seed)`` and then the reference's rescale, in eval
    mode."""
    torch.manual_seed(seed)
    return rescale_params(Demucs(**kwargs), reference=0.1).eval()


def demucs_phase(dev, queries: torch.Tensor) -> Demucs:
    """Phase 16: the published Demucs with seeded weights on ``queries``
    (DEMUCS_BATCH, 8 s) of degraded audio: its strict float32 forward,
    finite, within 1e-4 of its largest output from the CPU's on 2 clips, and
    its cuDNN LSTM within 1e-4 of a float64 copy on the same operands.
    Returns the strict float32 model on the card."""
    on_cpu = seeded_demucs(DEMUCS_SEED)
    strict = copy.deepcopy(on_cpu).to(dev)
    strict_hook = demucs_denoiser(strict)
    few = queries[:8]
    want = strict_hook(few)
    cpu_out = demucs_denoiser(on_cpu)(queries[:DEMUCS_CPU_EXAMPLES].cpu())
    card_vs_cpu = _rel_max(want[:DEMUCS_CPU_EXAMPLES].cpu(), cpu_out)
    # the LSTM on its own operands (the encoder's output), TF32 off, against
    # float64
    lstm64 = copy.deepcopy(strict.lstm.lstm).double()
    with torch.inference_mode(), cudnn_tf32(False):
        enc = strict(queries[:16], stop_at="enc").transpose(1, 2).contiguous()
        lstm_rel = _rel_max(strict.lstm.lstm(enc)[0].double(), lstm64(enc.double())[0])

    line = {
        "phase": "demucs", "model": "Demucs() hidden 48, depth 5, causal, x4", "seed": DEMUCS_SEED,
        "input": list(queries.shape), "output_finite": bool(torch.isfinite(want).all()),
        "card_vs_cpu_rel": card_vs_cpu, "card_vs_cpu_examples": DEMUCS_CPU_EXAMPLES,
        "lstm_vs_float64_rel": lstm_rel,
    }
    emit(line)
    if not line["output_finite"] or want.shape != few.shape:
        fail(f"the Demucs output is not finite or of shape {tuple(want.shape)}")
    if not card_vs_cpu <= MAX_DEMUCS_CARD_VS_CPU:
        fail(f"the Demucs on the card is {card_vs_cpu} of its largest output away from the CPU")
    if not lstm_rel <= MAX_LSTM_STRICT_REL:
        fail(f"the strict float32 cuDNN LSTM is {lstm_rel} from float64")
    return strict


def demucs_denoised_phase(label, model, ht, dm, analyzer, queries, aug_default, q_names, q_paths,
                          cleans_dir) -> dict:
    """Phase 17 (and 20 with trained weights): ``compute_accuracy_batched``
    with the plain analyzer and one denoising with ``demucs_denoiser(model)``
    over the first 256 clean and ``default_parameters`` queries; the
    denoised arm alone, whose verdicts must equal the plain matcher's on
    batches denoised beforehand, the hook called once per batch; then
    ``compute_peaks_metrics_batched``: eight finite numbers. Prune launches
    counted from just before the accuracies to just after the metrics."""
    hook = demucs_denoiser(model)
    calls = []

    def counted(w):
        calls.append(tuple(w.shape))
        return hook(w)

    den = AudfprintPeaks(afp_settings["audfprint"], denoising=True, denoising_model="demucs",
                         wave_denoiser=counted, device=dm.device)
    expected = []
    for s in range(0, DENOISED_QUERIES, QUERY_BATCH):
        expected += dm.match_waveforms(hook(aug_default[s : s + QUERY_BATCH]), shifts=SHIFTS)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    HC.reset_launch_counts()
    sets = {}
    for name, qs in (("cleans", queries[:DENOISED_QUERIES]), ("default_parameters", list(aug_default))):
        sets[name] = compute_accuracy_batched(qs, ht, analyzer, den, batch_size=QUERY_BATCH,
                                              shifts=SHIFTS, device_matcher=dm, names=q_names,
                                              device=dm.device)
    recorded = []
    match = dm.match_waveforms

    def recording(*args, **kwargs):
        out = match(*args, **kwargs)
        recorded.extend(out)
        return out

    calls.clear()
    dm.match_waveforms = recording
    try:
        compute_accuracy_batched(list(aug_default), ht, den, batch_size=QUERY_BATCH, shifts=SHIFTS,
                                 device_matcher=dm, names=q_names, device=dm.device)
    finally:
        del dm.match_waveforms
    arm_calls = list(calls)
    metrics = compute_peaks_metrics_batched(q_paths, analyzer, den, cleans_path=cleans_dir)
    launches = dict(K.LAUNCHES)
    # 2 sets x 2 arms, then the denoised arm alone
    hashes_counted(f"demucs_{label.split(':')[0]}", 5 * (DENOISED_QUERIES // QUERY_BATCH))
    line = {
        "phase": "demucs_denoised", "weights": label, "queries": DENOISED_QUERIES, "shifts": SHIFTS,
        "accuracy": sets, "hook_calls_denoised_arm": arm_calls,
        "denoised_arm_verdicts_equal_pre_denoised": recorded == expected,
        "peaks_metrics": metrics, "launches": launches,
    }
    emit(line)
    for name, acc in sets.items():
        if set(acc) != {"No Denoising", "With Denoising", "Mix Pipeline"}:
            fail(f"demucs_denoised {label} {name}: accuracies {sorted(acc)}")
    if arm_calls != [(QUERY_BATCH, QUERY_SECONDS * SR)] * (DENOISED_QUERIES // QUERY_BATCH):
        fail(f"demucs_denoised {label}: the waveform hook ran {arm_calls}, not once per batch")
    if recorded != expected:
        fail(f"demucs_denoised {label}: the denoised arm's verdicts differ from the plain matcher's "
             "on pre-denoised batches")
    if set(metrics) != set(PEAKS_METRICS) or not all(math.isfinite(v) for v in metrics.values()):
        fail(f"demucs_denoised {label}: peak metrics missing or not finite: {metrics}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"{k} kernel did not launch in the Demucs-denoised runs ({label})")
    return line


def demucs_train_step_check(dev) -> dict:
    """Phase 18: one strict float32 "audio" step of a seeded
    ``Demucs(hidden=8, depth=3)`` through ``Trainer.train_step`` on the card
    and on the CPU from the same weights and batch: the loss terms; the same
    step in float64, every gradient (float32 gradients of a ReLU network
    jump where rounding flips a ReLU, so they are not compared)."""
    clean = next(synthetic_clean_batches(8, TRAIN_SAMPLES, SR, seed=DEMUCS_SEED))
    r = np.random.default_rng(DEMUCS_SEED)
    aug = (0.7 * clean + 0.2 * r.standard_normal(clean.shape)).astype(np.float32)
    runs = {}
    weights = seeded_demucs(DEMUCS_SEED, hidden=8, depth=3).state_dict()
    for label, device, dtype in (("cpu", "cpu", torch.float32), ("card", dev, torch.float32),
                                 ("cpu64", "cpu", torch.float64), ("card64", dev, torch.float64)):
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(Demucs(hidden=8, depth=3).to(dtype), iter(()), 1,
                              iter(()), 1, DEMUCS_TRAIN_LR, 2, tmp, input_type="audio",
                              factor_sc=TP.FACTOR_SC, factor_mag=TP.FACTOR_MAG, device=device)
        trainer.model.load_state_dict(weights)  # over the trainer's own (Flax) initial weights
        terms = trainer.train_step(torch.from_numpy(clean).to(device, dtype),
                                   torch.from_numpy(aug).to(device, dtype))
        runs[label] = ({k: float(v) for k, v in terms.items()},
                       {k: p.grad.cpu() for k, p in trainer.model.named_parameters()})
    terms_c, terms_g = runs["cpu"][0], runs["card"][0]
    grads_c64, grads_g64 = runs["cpu64"][1], runs["card64"][1]
    line = {
        "phase": "demucs_train_step_check", "model": "Demucs(hidden=8, depth=3)",
        "batch": clean.shape[0], "samples": clean.shape[1],
        "terms_rel_max": max(abs(terms_g[k] - v) / abs(v) for k, v in terms_c.items()),
        "grad_rel_max_float64": max(_rel_max(grads_g64[k], grads_c64[k]) for k in grads_c64),
    }
    emit(line)
    if not line["terms_rel_max"] <= MAX_STEP_LOSS_REL:
        fail(f"Demucs train step: a loss term on the card is {line['terms_rel_max']} (relative) "
             "from the CPU's")
    if not line["grad_rel_max_float64"] <= MAX_STEP_GRAD_REL:
        fail(f"Demucs train step: a float64 gradient on the card is {line['grad_rel_max_float64']} "
             "of its largest value from the CPU's")
    return line


def demucs_train_phase(dev, noise_bank, ir_bank, ckpt_root: str) -> str:
    """Phase 19: the published Demucs trained by ``Trainer`` on the card
    ("audio": L1 + multi-resolution STFT, factors 0.5) with
    default_parameters augmentation inside each step, lr 5e-4, in strict
    float32 and in bfloat16 from Flax's initial weights, rescaled (the
    trainer's, as the JAX trainer's). Returns the float32 run's best
    checkpoint path."""
    params = test_pipelines_parameters["default_parameters"]
    fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device=dev)
    train_batches, val_batches = training_batches()
    runs = {}
    for label, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        trainer = Trainer(
            Demucs(dtype=dtype), cycle(train_batches), TRAIN_STEPS,
            cycle(val_batches), TRAIN_VAL_STEPS, DEMUCS_TRAIN_LR, TRAIN_EPOCHS + 1,
            os.path.join(ckpt_root, label), input_type="audio", augmenter=fp,
            factor_sc=TP.FACTOR_SC, factor_mag=TP.FACTOR_MAG,
            scheduler=ReduceLROnPlateau(factor=TP.FACTOR, patience=TP.PATIENCE),
            early_stopping=EarlyStopping(patience=TP.EARLY_STOP, min_delta=TP.MIN_DELTA),
            save=True, device=dev,
        )
        runs[label] = run_training(trainer, f"demucs_train, {label}")
        del trainer
        torch.cuda.empty_cache()
    emit({
        "phase": "demucs_train", "model": "Demucs(), Flax's init rescaled", "batch": TP.BATCH_SIZE,
        "samples": TRAIN_SAMPLES, "augmentation": "default_parameters, dcase_shaped_banks()",
        "lr": DEMUCS_TRAIN_LR, "epochs": TRAIN_EPOCHS, "steps_per_epoch": TRAIN_STEPS,
        "val_steps": TRAIN_VAL_STEPS, "runs": runs,
    })

    return os.path.join(ckpt_root, "float32", "best_epoch", "state.pt")


def streamer_phase(dev) -> dict:
    """Phase 21: ``DemucsStreamer`` over the seeded published Demucs at
    8 kHz, fed STREAM_SECONDS of white noise frame by frame as the
    reference's self-benchmark feeds it, then flushed: the delta to the
    offline forward (under 5%) and the real-time factor, the time per frame
    on the host's clock (which includes the copy of each frame's output to
    the host) over the stride (under 1)."""
    model = seeded_demucs(DEMUCS_SEED).to(dev)
    rng = np.random.default_rng(DEMUCS_SEED)
    noise = torch.from_numpy(rng.standard_normal((1, STREAM_SECONDS * SR), dtype=np.float32))

    def stream(x):
        s = DemucsStreamer(model)
        outs, pending, size = [], x, s.total_length
        while pending.shape[1] > 0:
            outs.append(s.feed(pending[:, :size]))
            pending, size = pending[:, size:], model.total_stride
        outs.append(s.flush())
        out = torch.cat(outs, dim=1)
        with torch.inference_mode():
            offline = model(x.to(dev)).cpu()
        delta = float(torch.linalg.norm(offline - out[:, : x.shape[1]]) / torch.linalg.norm(offline))
        return delta, s

    stream(noise[:, :SR])  # warm-up
    delta, s = stream(noise)
    line = {
        "phase": "streamer", "model": "Demucs() seeded, rescaled", "sample_rate": SR,
        "seconds": STREAM_SECONDS, "frames": s.frames, "delta_batch_streaming": delta,
        "rtf": s.time_per_frame / (s.stride / SR),
    }
    emit(line)
    if not delta < MAX_STREAM_DELTA:
        fail(f"streamer: batch/streaming delta {delta:.2%}")
    if not line["rtf"] < 1:
        fail(f"streamer: real-time factor {line['rtf']}")
    return line


# ------------------------------------------------------------------ Dejavu

DJ_SETTINGS = afp_settings["dejavu"]  # the paper's: 8 kHz, n_fft 512, hop 256, fan 3, amp_min 50
DJ_INGEST_BATCH = 256
DJ_ORACLE_TRACKS = 256
DJ_ORACLE_QUERIES = 128
DJ_DEMUCS_QUERIES = 32
DJ_UNET_CPU_QUERIES = 16
MIN_DJ_VERDICTS_CARD_VS_CPU = 126  # of a batch of 128


def dj_masks(waves: torch.Tensor, denoiser=None) -> torch.Tensor:
    st = DJ_SETTINGS
    return fingerprint_spectrogram_batch(
        waves, st["samplerate"], st["n_fft"], st["n_hop"], st["amp_min"], denoiser=denoiser
    )[1]


def dj_max_peaks(n_frames: int) -> int:
    """The matcher's default peak budget: 4 a frame, rounded up to a power
    of two."""
    return 1 << math.ceil(math.log2(4 * n_frames))


def dj_song(verdict):
    """The song a recognizer verdict names, or None (NOMATCH)."""
    return verdict["results"][0]["song_name"].decode() if verdict["match"] else None


def dj_recognize(dm, queries) -> list:
    """The verdicts of ``recognize_waveforms`` over ``queries`` (a (N, T)
    tensor or a list of (T,) tensors) in batches of QUERY_BATCH."""
    out = []
    for s in range(0, len(queries), QUERY_BATCH):
        chunk = queries[s : s + QUERY_BATCH]
        out += dm.recognize_waveforms(chunk if isinstance(chunk, torch.Tensor) else torch.stack(chunk))
    return out


def dj_accuracy(verdicts, gts) -> float:
    return sum(dj_song(v) == gt for v, gt in zip(verdicts, gts)) / len(gts)


def dejavu_ingest_phase(dev, tracks, cut_secs, names):
    """Phase 22: the corpus through ``DejavuDeviceIndex.ingest_arrays`` in
    batches of DJ_INGEST_BATCH tracks of one length (each track cut to
    ``cut_secs`` whole seconds; zero padding would move the per-track mean
    and so the peaks), then ``finalize`` and the matcher's upload.
    Returns (index, matcher, line)."""
    idx = DejavuDeviceIndex()
    batches = []
    for sec in np.unique(cut_secs):
        ids = np.nonzero(cut_secs == sec)[0]
        batches += [ids[s : s + DJ_INGEST_BATCH] for s in range(0, len(ids), DJ_INGEST_BATCH)]
    for ids in batches:
        n = int(cut_secs[ids[0]]) * SR
        idx.ingest_arrays([names[i] for i in ids], torch.stack([tracks[i][:n] for i in ids]),
                          DJ_SETTINGS, device=dev)
    starts, rows, nbuckets, depth = idx.finalize()
    dm = DejavuDeviceMatcher(idx, DJ_SETTINGS, device=dev)
    line = {
        "phase": "dejavu_ingest", "tracks": len(names), "batches": len(batches),
        "lengths_s": sorted(int(s) for s in np.unique(cut_secs)),
        "rows": int(rows.shape[0]), "nbuckets": nbuckets, "bucket_depth": depth,
        "rows_dropped": idx.rows_dropped, "max_rows_per_hash": idx.max_rows_per_hash,
    }
    return idx, dm, line


def dejavu_oracle_phase(dev, tracks, cut_secs, names, oracle_queries, gts, tids):
    """Phase 25: one set of card masks for the DJ_ORACLE_TRACKS tracks
    ``tids`` and the queries, fed to the host path (``peaks_from_mask`` ->
    ``generate_hashes`` -> SQLite -> ``find_matches`` -> ``align_matches``)
    and to the device path (``pack_hashes_from_masks`` ->
    ``_dejavu_match_impl`` through ``match_packed``): every field of every
    verdict must be equal. Returns (the SQLite-backed Dejavu, line)."""
    st = DJ_SETTINGS
    track_masks = {}
    for sec in np.unique(cut_secs[tids]):
        ids = [t for t in tids if cut_secs[t] == sec]
        for t, m in zip(ids, dj_masks(torch.stack([tracks[t][: int(sec) * SR] for t in ids]))):
            track_masks[t] = m
    q_masks = dj_masks(torch.stack(oracle_queries))

    djv = Dejavu({}, st, db=SQLiteDatabase(":memory:"), device=dev)
    for t in tids:
        hashes = set(generate_hashes(peaks_from_mask(track_masks[t].cpu().numpy()), st["fan_value"]))
        sid = djv.db.insert_song(names[t], "", len(hashes))
        djv.db.insert_hashes(sid, list(hashes))
        djv.db.set_song_fingerprinted(sid)
    host = []
    for m in q_masks.cpu().numpy():
        hashes = set(generate_hashes(peaks_from_mask(m), st["fan_value"]))
        matches, dedup, _ = djv.find_matches(hashes)
        host.append(djv.align_matches(matches, dedup, len(hashes)))

    idx = DejavuDeviceIndex()
    for t in tids:
        C = track_masks[t].shape[-1]
        keys, t1, valid, *_ = pack_hashes_from_masks(track_masks[t][None], dj_max_peaks(C), st["fan_value"])
        idx.add_song(names[t], zip(keys[valid].tolist(), t1[valid].tolist()))
    dm = DejavuDeviceMatcher(idx, st, device=dev)
    C = q_masks.shape[-1]
    device = dm.match_packed(
        pack_hashes_from_masks(q_masks, dj_max_peaks(C), st["fan_value"]), C)

    mismatched = []
    for i, (h, d) in enumerate(zip(host, device)):
        want = dict(h[0], song_id=h[0]["song_id"] - 1) if h else {}  # SQLite counts from 1
        if d != want:
            mismatched.append({"query": i, "host": repr(want), "device": repr(d)})
    line = {
        "phase": "dejavu_oracle", "tracks": len(tids), "queries": len(oracle_queries),
        "query_sets": "first half clean, second half default_parameters",
        "verdicts_compared": len(host), "host_nonempty": sum(bool(h) for h in host),
        "fields_compared": sorted(device[0]) if device and device[0] else [],
        "mismatched": len(mismatched), "first_mismatches": mismatched[:3],
        "accuracy_device": dj_accuracy(
            [{"match": bool(d), "results": [d]} for d in device], gts),
        "sqlite_fingerprints": djv.db.get_num_fingerprints(),

    }
    emit(line)
    if mismatched:
        fail(f"dejavu_oracle: {len(mismatched)} verdicts differ between align_matches and the "
             f"device matcher, first {mismatched[0]}")
    return djv, line


def dejavu_phases(dev, tracks, lengths, names, queries, q_ids, q_offs, unseen, augmented_host,
                  q_paths, cleans_dir, tmp):
    """Phases 22-28, Dejavu at the paper's settings on the script's corpus
    and queries: ingest, match, conditions, oracle, card against CPU, the
    two denoiser arms and the peak metrics. Returns the index."""
    cut_secs = lengths // SR
    crops_past_cut = int(sum(int(o) + QUERY_SECONDS * SR > int(cut_secs[t]) * SR
                             for t, o in zip(q_ids, q_offs)))
    idx, dm, ingest_line = dejavu_ingest_phase(dev, tracks, cut_secs, names)
    emit({**ingest_line, "crops_past_cut": crops_past_cut})

    # ---- 23. match: the 1,024 clean crops and the 128 unseen ones
    gts = [names[int(t)] for t in q_ids]
    accuracy = dj_accuracy(dj_recognize(dm, queries), gts)
    unseen_v = dj_recognize(dm, unseen)
    emit({"phase": "dejavu_match", "queries": len(queries), "batch": QUERY_BATCH,
          "accuracy": accuracy, "unseen_queries": len(unseen),
          "unseen_nomatch_rate_not_held": sum(not v["match"] for v in unseen_v) / len(unseen)})
    if accuracy < MIN_CLEAN_ACCURACY:
        fail(f"dejavu clean accuracy {accuracy} < {MIN_CLEAN_ACCURACY}")

    # ---- 24. conditions: the augmented queries of phase 7
    conditions = {"cleans": accuracy}
    for cond, out in augmented_host.items():
        conditions[cond] = dj_accuracy(dj_recognize(dm, out.to(dev)), gts)
    emit({"phase": "dejavu_conditions", "queries": len(queries), "accuracy": conditions})

    # ---- 25. oracle: the host SQLite path against the device path
    aug_default = augmented_host["default_parameters"]
    half = DJ_ORACLE_QUERIES // 2
    oracle_queries = list(queries[:half]) + [aug_default[i].to(dev) for i in range(half, 2 * half)]
    oracle_gts = gts[: 2 * half]
    tids = list(dict.fromkeys(int(t) for t in q_ids[: 2 * half]))
    have = set(tids)
    tids += [t for t in range(len(names)) if t not in have][: DJ_ORACLE_TRACKS - len(tids)]
    oracle_djv, _ = dejavu_oracle_phase(dev, tracks, cut_secs, names, oracle_queries, oracle_gts, tids)

    # ---- 26. the card against the CPU on one batch, the same index
    q_batch = torch.stack(queries[:QUERY_BATCH])
    m_card, m_cpu = dj_masks(q_batch).cpu(), dj_masks(q_batch.cpu())
    cpu_dm = DejavuDeviceMatcher(idx, DJ_SETTINGS, device="cpu")
    v_cpu = cpu_dm.recognize_waveforms(q_batch.cpu())
    v_card = dm.recognize_waveforms(q_batch)
    C = m_cpu.shape[-1]
    packed = pack_hashes_from_masks(m_cpu, dj_max_peaks(C), DJ_SETTINGS["fan_value"])
    kw = dm._match_kwargs(dm._effective_mqf(C))
    on_cpu = dj_match_impl(cpu_dm._starts, cpu_dm._rows, *packed[:4], **kw)
    on_card = dj_match_impl(dm._starts, dm._rows, *(p.to(dev) for p in packed[:4]), **kw)
    impl_equal = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    agreement = float((m_card == m_cpu).float().mean())
    same_songs = sum(dj_song(a) == dj_song(b) for a, b in zip(v_card, v_cpu))
    emit({"phase": "dejavu_card_vs_cpu", "queries": QUERY_BATCH, "mask_agreement": agreement,
          "verdict_songs_equal": same_songs, "verdicts_equal": v_card == v_cpu,
          "match_impl_equal_on_same_hashes": impl_equal})
    if agreement < MIN_MASK_AGREEMENT:
        fail(f"dejavu masks on the card and the CPU agree in {agreement} of cells")
    if same_songs < MIN_DJ_VERDICTS_CARD_VS_CPU:
        fail(f"dejavu verdict songs on the card and the CPU agree in {same_songs} of {QUERY_BATCH}")
    if not impl_equal:
        fail("_dejavu_match_impl on the card differs from the CPU on the same hashes")
    del cpu_dm

    # ---- 27. denoised: the seeded UNet as spectrogram hook, the seeded
    # Demucs as waveform hook
    dirs = {}
    for label, qs in (("cleans", queries[:DENOISED_QUERIES]),
                      ("default_parameters", aug_default[:DENOISED_QUERIES])):
        dirs[label] = os.path.join(tmp, f"dejavu_{label}")
        os.mkdir(dirs[label])
        for i, q in enumerate(qs):  # the file's stem is the ground truth
            np.save(os.path.join(dirs[label], f"{gts[i]}.{i:04d}.npy"), q.cpu().numpy())
    unet = seeded_unet(UNET_SEED)
    unet_hook = unet_denoiser(copy.deepcopy(unet).to(dev))
    dm_unet = DejavuDeviceMatcher(idx, DJ_SETTINGS, spec_denoiser=unet_hook, device=dev)
    unet_sets = {}
    for label, d in dirs.items():
        files = [os.path.join(d, f) for f in sorted(os.listdir(d))]
        unet_sets[label] = dj_exps.compute_accuracy_batched(files, dm, dm_unet, batch_size=QUERY_BATCH)
    few = aug_default[:DJ_UNET_CPU_QUERIES]
    m_few_cpu = dj_masks(few, denoiser=unet_denoiser(unet))
    unet_agreement = float((dj_masks(few.to(dev), denoiser=unet_hook).cpu() == m_few_cpu).float().mean())
    del unet
    demucs = seeded_demucs(DEMUCS_SEED).to(dev)
    demucs_hook = demucs_denoiser(demucs)
    djv_demucs = Dejavu({}, DJ_SETTINGS, db=oracle_djv.db, denoising=True, denoising_model="demucs",
                        wave_denoiser=demucs_hook, device=dev)
    demucs_dir = os.path.join(tmp, "dejavu_oracle_queries")
    os.mkdir(demucs_dir)
    for i in range(DJ_DEMUCS_QUERIES):  # half clean, half default_parameters
        j = i if i < DJ_DEMUCS_QUERIES // 2 else half + i
        np.save(os.path.join(demucs_dir, f"{oracle_gts[j]}.{j:04d}.npy"), oracle_queries[j].cpu().numpy())
    files = [os.path.join(demucs_dir, f) for f in sorted(os.listdir(demucs_dir))]
    demucs_acc = dj_exps.compute_accuracy(files, oracle_djv, djv_demucs)
    emit({"phase": "dejavu_denoised", "unet": "base=64, seeded", "demucs": "published, seeded",
          "unet_accuracy": unet_sets, "unet_card_vs_cpu_mask_agreement": unet_agreement,
          "unet_card_vs_cpu_queries": DJ_UNET_CPU_QUERIES,
          "demucs_per_file_queries": len(files), "demucs_corpus_tracks": DJ_ORACLE_TRACKS,
          "demucs_accuracy": demucs_acc})
    for label, acc in list(unet_sets.items()) + [("demucs", demucs_acc)]:
        if set(acc) != {"No Denoising", "With Denoising", "Mix Pipeline"}:
            fail(f"dejavu_denoised {label}: accuracies {sorted(acc)}")
    if unet_agreement < MIN_MASK_AGREEMENT:
        fail(f"dejavu UNet-denoised masks on the card and the CPU agree in {unet_agreement} of cells")

    # ---- 28. peak metrics of phase 12's .npy pairs, both arms
    djv_plain = Dejavu({}, DJ_SETTINGS, db=SQLiteDatabase(":memory:"), device=dev)
    peaks = {}
    for label, kw in (("unet", {"spec_denoiser": unet_hook}), ("demucs", {"wave_denoiser": demucs_hook})):
        den = Dejavu({}, DJ_SETTINGS, db=djv_plain.db, denoising=True, denoising_model=label,
                     device=dev, **kw)
        metrics = peaks[label] = dj_exps.compute_peaks_metrics_batched(
            q_paths, djv_plain, den, cleans_path=cleans_dir)
        if set(metrics) != set(dj_exps.PEAKS_METRICS) or not all(map(math.isfinite, metrics.values())):
            fail(f"dejavu peak metrics ({label}) missing or not finite: {metrics}")
    emit({"phase": "dejavu_peaks_metrics", "queries": len(q_paths), "metrics": peaks})
    return idx


# ---- 30-34. the last slice: mp3 corpora and the FMA selection, the parallel
# layer, monitoring and the CQT loss, the demo CLI, the app

FMA_GENRES = (
    "Electronic", "Experimental", "Rock", "Hip-Hop", "Folk", "Instrumental", "Pop",
    "International", "Classical", "Old-Time / Historic", "Jazz", "Country", "Soul-RnB",
    "Spoken", "Blues", "Easy Listening",
)
FMA_TRACKS_PER_GENRE = 512  # 8,192 rows: every genre kept (< 900), all six exceptions popped
FMA_WRITTEN = 256  # K: the first selected tracks, written as files (the rest are absent); cut from 512 for the time limit
FMA_SR = 22050  # libmp3lame's 128 kbit/s, as tests/make_mp3_fixture.py encodes
FMA_SECONDS = 30  # FMA-large's clips
FMA_SEED = 2024
CODEC_THREADS = 8
MIN_FMA_ACCURACY = 0.99
PARALLEL_STEPS = 3
MAX_DDP_LOSS_DIFF = 1e-6
MESH_QUERIES = 256
CQT_BATCH = 128
CQT_CPU_EXAMPLES = 8
MAX_CQT_CARD_VS_CPU = 1e-5
APP_BATCH, APP_SECONDS, APP_SR, APP_SEED = 4, 8, 16000, 16


@contextlib.contextmanager
def environment(**values):
    """``os.environ`` with ``values`` set inside the block."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def quietly(fn):
    """``fn()`` with its standard output kept (an entry point prints a line
    per file it skips): (result, output). The output goes to standard error
    if ``fn`` raises."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    except BaseException:
        print(buf.getvalue()[-4000:], file=sys.stderr)
        raise
    return out, buf.getvalue()


def native_io_phase() -> dict:
    """Phase 30, part one: the g++ build of ``native/*.cc`` and whether the
    codecs load. Fails if the library does not build."""
    try:
        lib = native.build()
        native.library()
        mp3_dec = native.mp3_available()
    except (RuntimeError, OSError) as e:
        fail(f"the native decoders did not build or load: {e}")
    line = {"phase": "native_io", "library": lib,
            "libmpg123": mp3_dec, "libmp3lame": mp3_encode.available(),
            "libmp3lame_error": mp3_encode.load_error()}
    line["mp3"] = line["libmpg123"] and line["libmp3lame"]
    if not line["mp3"]:
        line["mp3_reason"] = ("libmpg123.so.0 did not load" if not mp3_dec
                              else f"libmp3lame did not load: {line['libmp3lame_error']}")
    return line


def write_fma_tree(dev, root: str, use_mp3: bool) -> dict:
    """An FMA tree under ``root``: ``fma_metadata/tracks.csv`` in FMA's
    layout (16 genres x 512 tracks of 30 s, shuffled), the list of every
    track's path as the dataset's ``fma_large_preprocessed.txt``, the
    preprocessing ``main`` (through its entry point), then the first
    FMA_WRITTEN selected tracks (in the table's order) written as files: synthetic 30 s
    tracks at 22.05 kHz, mp3 (or WAV where a codec is missing) encoded on
    CODEC_THREADS threads. Returns the tree's counts and the written paths."""
    fma, dataset = os.path.join(root, "fma"), os.path.join(root, "dataset")
    os.makedirs(os.path.join(fma, "fma_metadata"))
    os.makedirs(dataset)
    rng = np.random.default_rng(FMA_SEED)
    n = len(FMA_GENRES) * FMA_TRACKS_PER_GENRE
    tids = rng.choice(np.arange(2, 160_000), size=n, replace=False)
    genres = np.repeat(FMA_GENRES, FMA_TRACKS_PER_GENRE)[rng.permutation(n)]
    write_fma_tracks_csv(os.path.join(fma, "fma_metadata", "tracks.csv"), tids, genres,
                         [FMA_SECONDS] * n)
    with open(os.path.join(dataset, "fma_large_preprocessed.txt"), "w") as fh:
        fh.write("\n".join(fma_preprocessing.track_id_to_path(t) for t in tids) + "\n")
    fma_preprocessing.main()
    table = fma_preprocessing.preprocessed_table()
    ts = fma_preprocessing.TestSet(table)
    ts.remove_short_tracks()
    selected = ts.remove_exceptions(ts.sample_queries())
    if len(selected) != n - len(fma_preprocessing.EXCEPTION_POSITIONS):
        fail(f"the FMA selection has {len(selected)} tracks, not {n - 6}")
    # the first selected tracks in the table's order, so that the index's
    # batches of 64 paths hold them together
    chosen = set(selected)
    written = [p for p in table["file_paths"] if p in chosen][:FMA_WRITTEN]

    def encode(args):
        path, x = args
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if use_mp3:
            mp3_encode.encode_mp3(x, path, FMA_SR)
        else:
            import scipy.io.wavfile

            scipy.io.wavfile.write(path, FMA_SR, (np.clip(x, -1, 1) * 32767).astype(np.int16))

    with cf.ThreadPoolExecutor(CODEC_THREADS) as pool:
        for s in range(0, len(written), 64):
            block = synth_tracks_device(FMA_SEED, range(s, s + 64), FMA_SECONDS * FMA_SR, FMA_SR,
                                        device=dev)
            block = (0.8 * block).cpu().numpy()
            list(pool.map(encode, zip(written[s : s + 64], block)))
    return {"metadata_rows": n, "selected": len(selected), "written": written}


def fma_eval_phase(dev, tmp: str, io_line: dict) -> dict:
    """Phases 30 and 31, the slice's main path at full width: the FMA tree
    (``write_fma_tree``), the threaded batch decoder over its files, then
    through the entry points the audfprint ``--action index`` (the full
    2^20 x 100 table), the Dejavu ``--action index`` (the paper's settings,
    SQLite), ``--queries cleans --save`` (the selection's missing files are
    skipped), and the saved clean queries identified by both systems:
    accuracy >= 0.99. The prune counters are zeroed before the index and
    before the identification and read after each."""
    use_mp3 = io_line["mp3"]
    root = os.path.join(tmp, "fma_eval")
    os.makedirs(root)
    ext = ".mp3" if use_mp3 else ".wav"
    to_path = fma_preprocessing.track_id_to_path
    if not use_mp3:  # the same tree as WAV files
        fma_preprocessing.track_id_to_path = lambda t: to_path(t)[:-4] + ext
    cwd = os.getcwd()
    db_path = os.path.join(root, "fp_database.npz")
    cleans = os.path.join(root, "queries", "cleans")
    saved = (afp_db_paths["audfprint"], queries_paths["cleans"])
    try:
        with environment(MFPA_FMA_ROOT=os.path.join(root, "fma"),
                         MFPA_DATASET_DIR=os.path.join(root, "dataset")):
            tree = write_fma_tree(dev, root, use_mp3)
            files = tree.pop("written")
            decoded = native.read_wav_batch(files, num_threads=CODEC_THREADS)
            if any(d is None for d in decoded):
                fail("read_wav_batch failed on a written file")
            del decoded
            io_line.update({"decode_files": len(files), "format": ext})
            emit(io_line)

            os.chdir(root)  # the Dejavu database is the working directory's ./dejavu_fma
            afp_db_paths["audfprint"] = db_path
            queries_paths["cleans"] = cleans
            an = AudfprintPeaks(afp_settings["audfprint"], device=dev)
            K.reset_launch_counts()
            HC.reset_launch_counts()
            _, index_out = quietly(
                lambda: audfprint_exps.main(["--action", "index", "--device", str(dev)]))
            launches_index = dict(K.LAUNCHES)
            hashes_counted("fma_index")
            _, dj_out = quietly(lambda: dj_exps.main(["--action", "index", "--device", str(dev)]))
            if dict(K.LAUNCHES) != launches_index:
                fail("the Dejavu index launched a prune kernel")
            _, q_out = quietly(lambda: generate_queries.main(["--queries", "cleans", "--save"]))
            q_files = sorted(glob.glob(os.path.join(cleans, "*.pkl")))

            ht = HashTable(db_path)
            dm = DeviceMatcher(ht, device=dev)
            K.reset_launch_counts()
            HC.reset_launch_counts()
            acc, _ = quietly(lambda: compute_accuracy_batched(
                q_files, ht, an, batch_size=QUERY_BATCH, shifts=SHIFTS, device_matcher=dm,
                device=dev))
            launches_ident = dict(K.LAUNCHES)
            hashes_counted("fma_identify")
            djv = Dejavu(afp_db_paths["dejavu"], DJ_SETTINGS, "set", device=dev)
            dj_acc, _ = quietly(lambda: dj_exps.compute_accuracy(q_files, djv, djv))
            n_songs = len(djv.db.get_songs())
    finally:
        os.chdir(cwd)
        afp_db_paths["audfprint"], queries_paths["cleans"] = saved
        fma_preprocessing.track_id_to_path = to_path
    line = {
        "phase": "fma_eval", "format": ext, "metadata_rows": tree["metadata_rows"],
        "selected": tree["selected"], "files_written": len(files),
        "track_seconds": FMA_SECONDS, "sample_rate": FMA_SR,
        "audfprint_index": {
            "tracks_indexed": len(ht.names), "paths_skipped": index_out.count("error with"),
            "table": [int(1 << ht.hashbits), int(ht.depth)], "launches": launches_index},
        "dejavu_index": {"songs": n_songs, "paths_skipped": dj_out.count("Failed fingerprinting")},
        "clean_queries": {"written": len(q_files),
                          "missing_skipped": q_out.count("A file is missing")},
        "audfprint_identify": {"accuracy": acc["No Denoising"], "queries": len(q_files),
                               "shifts": SHIFTS, "launches": launches_ident},
        "dejavu_identify": {"accuracy": dj_acc["No Denoising"], "queries": len(q_files),
                            "path": "per file: FileRecognizer over SQLite"},
    }
    emit(line)
    if len(ht.names) != len(files) or n_songs != len(files) or len(q_files) != len(files):
        fail(f"fma_eval: {len(ht.names)} indexed, {n_songs} Dejavu songs, {len(q_files)} queries "
             f"of {len(files)} files")
    for system in ("audfprint_identify", "dejavu_identify"):
        if line[system]["accuracy"] < MIN_FMA_ACCURACY:
            fail(f"fma_eval: {system} accuracy {line[system]['accuracy']} < {MIN_FMA_ACCURACY}")
    for k in K.LAUNCHES:
        if launches_index[k] <= 0 or launches_ident[k] <= 0:
            fail(f"{k} kernel did not launch in the FMA index and identification")
    return {"index": launches_index, "identify": launches_ident}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_phase(dev, noise_bank, ir_bank, queries, ht, dm, dj_idx) -> dict:
    """Phase 32: an NCCL group of world size 1 in this process; the
    published UNet (base=64, float32, batch 128 x 3 s, default_parameters
    augmentation on the card) for PARALLEL_STEPS steps without and with
    ``DistributedDataParallel`` from one seed (losses within 1e-6);
    ``ShardedAugmenter`` over ``[cuda:0, cuda:0]`` against ``apply`` on the
    whole batch, and both matchers on that mesh against one device on
    MESH_QUERIES queries: bit for bit. Returns the prune launches of the
    mesh's audfprint call."""
    params = test_pipelines_parameters["default_parameters"]
    fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device=dev)
    train_batches, _ = training_batches()
    runs = {}
    # both runs take cuDNN's deterministic algorithms, so that what differs
    # is DDP's doing (the default ones read up to 5e-7 apart at step 3)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label in ("single", "ddp"):
            if label == "ddp":
                rank = init_multihost(f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0,
                                      device=dev)
            torch.manual_seed(UNET_SEED)
            with tempfile.TemporaryDirectory() as ckpt:
                trainer = Trainer(UNet(1, 1, rate=0.05, base=64), iter(()), 1, iter(()), 1, TRAIN_LR,
                                  2, ckpt, input_type="spec", augmenter=fp, device=dev)
            losses = [float(trainer.train_step(b)["loss"]) for b in train_batches[:PARALLEL_STEPS]]
            runs[label] = {"losses": losses, "module": type(trainer._train_model).__name__}
            del trainer
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    import torch.distributed as dist

    backend = dist.get_backend()
    dist.destroy_process_group()
    loss_diff = max(abs(a - b) for a, b in zip(runs["single"]["losses"], runs["ddp"]["losses"]))

    mesh = [dev, dev]
    clean = torch.stack(queries[:MESH_QUERIES])
    sa = ShardedAugmenter(fp, mesh)
    sharded = torch.cat(sa.batch_augment(clean, key=prng.key(AUGMENT_SEED)))
    whole = fp.apply(clean, fp.draw(MESH_QUERIES, clean.shape[-1], prng.key(AUGMENT_SEED)))
    aug_mismatch = int((sharded != whole).sum())
    q = whole  # degraded queries for the matchers
    single = dm.match_waveforms(q, shifts=SHIFTS)
    K.reset_launch_counts()
    HC.reset_launch_counts()
    meshed = DeviceMatcher(ht, device=dev, mesh=mesh)
    mesh_v = meshed.match_waveforms(q, shifts=SHIFTS)
    launches = dict(K.LAUNCHES)
    hashes_counted("mesh_match", len(mesh))  # one a shard
    dj_single = DejavuDeviceMatcher(dj_idx, DJ_SETTINGS, device=dev).match_waveforms(q)
    dj_mesh = DejavuDeviceMatcher(dj_idx, DJ_SETTINGS, mesh=mesh).match_waveforms(q)
    line = {
        "phase": "parallel", "backend": backend, "world_size": 1, "rank": rank,
        "unet": "base=64, rate 0.05, float32, cuDNN deterministic", "batch": TP.BATCH_SIZE,
        "samples": TRAIN_SAMPLES,
        "steps": PARALLEL_STEPS, "runs": runs, "max_loss_diff": loss_diff,
        "mesh": [str(d) for d in mesh], "replicas": len(meshed._replicas),
        "sharded_augment_examples": MESH_QUERIES, "sharded_augment_mismatched_cells": aug_mismatch,
        "audfprint_mesh_equal": mesh_v == single, "dejavu_mesh_equal": dj_mesh == dj_single,
        "mesh_matches": sum(v[0] == "MATCH" for v in mesh_v), "launches": launches,
    }
    emit(line)
    if runs["ddp"]["module"] != "DistributedDataParallel" or runs["single"]["module"] != "UNet":
        fail(f"parallel: trained through {runs['single']['module']} and {runs['ddp']['module']}")
    if not loss_diff <= MAX_DDP_LOSS_DIFF:
        fail(f"parallel: the DDP losses are {loss_diff} from the single-process ones")
    if aug_mismatch or not line["audfprint_mesh_equal"] or not line["dejavu_mesh_equal"]:
        fail(f"parallel: sharded results differ from one device: {aug_mismatch} augmented cells, "
             f"audfprint {line['audfprint_mesh_equal']}, dejavu {line['dejavu_mesh_equal']}")
    for k, n in launches.items():
        if n <= 0:
            fail(f"{k} kernel did not launch in the mesh match")
    return launches


class RecordingWriter:
    """``SummaryWriter``'s three calls, recorded (where tensorboard does not
    import)."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, float(value), step))

    def add_audio(self, tag, clip, step, sample_rate):
        self.calls.append(("audio", tag, np.asarray(clip), step))

    def add_image(self, tag, img, step, dataformats):
        self.calls.append(("image", tag, np.asarray(img), step))


class TeeWriter(RecordingWriter):
    """A ``SummaryWriter`` whose calls are also recorded, to be checked."""

    def __init__(self, writer):
        super().__init__()
        self.writer = writer

    def add_scalar(self, tag, value, step):
        super().add_scalar(tag, value, step)
        self.writer.add_scalar(tag, value, step)

    def add_audio(self, tag, clip, step, sample_rate):
        super().add_audio(tag, clip, step, sample_rate)
        self.writer.add_audio(tag, clip, step, sample_rate=sample_rate)

    def add_image(self, tag, img, step, dataformats):
        super().add_image(tag, img, step, dataformats)
        self.writer.add_image(tag, img, step, dataformats=dataformats)


def monitoring_phase(dev, noise_bank, ir_bank, ckpt_root: str, tmp: str) -> None:
    """Phase 33: the train phase's float32 checkpoint resumed by a
    monitoring ``Trainer``: ``_log_tensorboard`` and ``_log_media`` (a
    ``SummaryWriter`` where tensorboard imports, a recording writer
    otherwise; the triplets must be finite, of the spectrogram's shape, at
    most 1); ``multi_resolution_cqt_loss`` at 128 x 3 s (finite; the card
    against the CPU on 8 examples, 1e-5); ``generate_audios.main`` on that
    checkpoint: its wavs written."""
    params = test_pipelines_parameters["default_parameters"]
    fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device=dev)
    _, val_batches = training_batches()
    try:
        from torch.utils.tensorboard import SummaryWriter

        writer, kind = TeeWriter(SummaryWriter(os.path.join(tmp, "tb"))), "SummaryWriter"
    except ImportError:
        writer, kind = RecordingWriter(), "recording writer (tensorboard does not import)"
    ckpt = os.path.join(ckpt_root, "float32")
    trainer = Trainer(UNet(1, 1, rate=0.05, base=64), iter(()), 1, cycle(val_batches), 1, TRAIN_LR,
                      TRAIN_EPOCHS + 1, ckpt, input_type="spec", augmenter=fp, monitoring=True,
                      device=dev, writer=writer)
    val, metrics = trainer.validation_epoch()
    trainer._log_tensorboard(trainer.epoch_start, {"loss": val["loss"]}, val, metrics)
    trainer._log_media(10)
    images = [c for c in writer.calls if c[0] == "image"]
    shape = (257, 1 + TRAIN_SAMPLES // 256, 1)
    bad = [c[1] for c in images if c[2].shape != shape or not np.isfinite(c[2]).all()
           or c[2].max() > 1.0 + 1e-6]
    if hasattr(writer, "writer"):
        writer.writer.close()
    del trainer
    torch.cuda.empty_cache()

    x = torch.from_numpy(val_batches[0][:CQT_BATCH]).to(dev)
    y = fp.apply(x, fp.draw(CQT_BATCH, x.shape[-1], prng.key(0)))
    card = [float(v) for v in cqt.multi_resolution_cqt_loss(y[:CQT_CPU_EXAMPLES], x[:CQT_CPU_EXAMPLES])]
    cpu = [float(v) for v in cqt.multi_resolution_cqt_loss(y[:CQT_CPU_EXAMPLES].cpu(),
                                                           x[:CQT_CPU_EXAMPLES].cpu())]
    cqt_err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    mag_card = cqt.cqt_magnitude(y[:CQT_CPU_EXAMPLES]).cpu()
    mag_cpu = cqt.cqt_magnitude(y[:CQT_CPU_EXAMPLES].cpu())
    mag_err = float((mag_card - mag_cpu).abs().max() / mag_cpu.abs().max())
    full = [float(v) for v in cqt.multi_resolution_cqt_loss(y, x)]

    out_dir = os.path.join(tmp, "generated_audios")
    written, _ = quietly(lambda: generate_audios.main(
        ["--model", "unet", "--checkpoint", ckpt, "--out", out_dir, "--seconds", "3",
         "--device", str(dev)]))
    line = {
        "phase": "monitoring", "writer": kind, "scalars": sum(c[0] == "scalar" for c in writer.calls),
        "images": len(images), "image_shape": list(shape), "bad_images": bad,
        "cqt_batch": CQT_BATCH, "cqt_samples": TRAIN_SAMPLES,
        "cqt_losses": full, "cqt_card_vs_cpu_rel": cqt_err, "cqt_cpu_examples": CQT_CPU_EXAMPLES,
        "cqt_magnitude_card_vs_cpu_of_max": mag_err,
        "generate_audios_files": sorted(map(os.path.basename, written)),
    }
    emit(line)
    if len(images) != 9 or bad or line["scalars"] < 3:
        fail(f"monitoring: {len(images)} images ({bad} bad), {line['scalars']} scalars")
    if not max(cqt_err, mag_err) <= MAX_CQT_CARD_VS_CPU or not all(map(math.isfinite, full)):
        fail(f"monitoring: the CQT loss on the card is {cqt_err} from the CPU's ({full})")
    wavs = {"clean.wav", "augmented.wav"}
    if not wavs <= set(line["generate_audios_files"]) or not all(
            os.path.getsize(p) > 1000 for p in written):
        fail(f"generate_audios wrote {line['generate_audios_files']}")


class StandIn:
    """The streamlit calls the app's panel makes, each answering its
    default."""

    def markdown(self, *args, **kwargs):
        pass

    def slider(self, label, min_value, max_value, step, value):
        return value

    def checkbox(self, label, value):
        return value


def app_phase(dev) -> None:
    """Phase 34: the demo app's ``define_model`` with a stand-in panel, then
    ``process_audio`` of 4 x 8 s at 16 kHz on the card: the wav bytes decode
    to finite audio of peak <= 1."""
    import scipy.io.wavfile

    model = streamlit_app.define_model(StandIn(), device=dev)
    x = 0.8 * synth_tracks_device(APP_SEED, range(APP_BATCH), APP_SECONDS * APP_SR, APP_SR,
                                  device=dev).cpu().numpy()[:, None, :]
    outs = streamlit_app.process_audio(x, [APP_SR] * APP_BATCH, model)
    decoded = [scipy.io.wavfile.read(io.BytesIO(o)) for o in outs]
    peaks = [float(np.abs(y.astype(np.float64) / 32767).max()) for _, y in decoded]
    line = {"phase": "app", "device": str(model.device), "batch": APP_BATCH,
            "seconds_each": APP_SECONDS, "sample_rate": APP_SR, "parameters": model.parameters,
            "peaks": peaks, "rates": [sr for sr, _ in decoded]}

    emit(line)
    if model.device.type != "cuda" or len(outs) != APP_BATCH:
        fail(f"app: {len(outs)} outputs on {model.device}")
    for sr, y in decoded:
        if sr != APP_SR or y.shape != (APP_SECONDS * APP_SR,) or not np.isfinite(y).all():
            fail(f"app: an output decodes to {sr} Hz, shape {y.shape}")
    if max(peaks) > 1.0:
        fail(f"app: peak {max(peaks)} above 1")


# ---------------------------------------------------------------- scale

# Phases 35-43: the reference-scale proofs through their stage functions,
# as their CLIs call them: the corpus is 106,574 storage-free 30 s tracks
# (FMA-large's size), seed 1234 (the CLIs' default)
SCALE_TRACKS = 106_574
SCALE_SEED = SP.parser().get_default("corpus_seed")
SCALE_BATCH = 128
SCALE_FIRST_MINUTES = 0.5  # the first ingest invocation stops here, the second resumes
SCALE_QUERIES = 512  # cut from 1,024 to keep the script within half its time limit
SCALE_SHIFTS = 4
SCALE_DENOISED_QUERIES = 128  # cut from 256, as SCALE_QUERIES
SCALE_DEMUCS_QUERIES = 128
SCALE_PEAKS_QUERIES = 256
SCALE_TRAIN = ("--train-epochs", "2", "--train-steps", "4")  # the JAX defaults cut from 20 x 16
SCALE_DEMUCS_TRAIN_BATCH = 16  # the JAX proof's Demucs run
SCALE_ORACLE_N = 32
SCALE_INGEST_STATS = (
    "total_hashes", "stored_hashes", "reservoir_dropped_pct", "buckets_at_depth",
    "buckets_over_depth", "max_bucket_count", "hash_overflow",
)
SCALE_MATCH_KEYS = ("accuracy", "accuracy_den", "accuracy_mix", "accuracy_den_demucs",
                    "accuracy_mix_demucs", "n_queries")
DJ_SCALE_KEYS = ("total_rows", "total_rows_stored", "bucket_depth", "index_mb", "rows_dropped",
                 "hash_overflow")
DEMO_ARGS = ("--tracks", "16", "--epochs", "2", "--queries", "16")  # its quick size


# ------------------------------------------------------------ draws

PRNG_KEYS = 1024  # x 1,024 draws a key: 2^20 draws a function
CORPUS_TRACKS = 64
QUERY_CHECK_N = 64
MAX_CORPUS_CARD_VS_CPU = 1e-5  # of the peak
MAX_QUERIES_CARD_VS_CPU = 1e-4
MAX_NORMAL_ULP = 2


def _ulps(a: np.ndarray, b: np.ndarray) -> float:
    return float((np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))).max())


def prng_phase(dev) -> dict:
    """The threefry functions on the card against the CPU over 2^20 draws
    each: every bit equal but ``normal``'s (the devices' ``log1p``)."""
    keys = {d: prng.split(prng.key(AUGMENT_SEED, d), PRNG_KEYS) for d in ("cpu", dev)}
    shape = (1024,)
    fns = {
        "split": lambda k: prng.split(k, 1024 // 2),
        "fold_in": lambda k: prng.fold_in(k[:, None], torch.arange(1024, device=k.device)),
        "uniform": lambda k: prng.uniform(k, shape, -3.5, 80.25),
        "randint": lambda k: prng.randint(k, shape, 0, 64001),
        "bernoulli": lambda k: prng.bernoulli(k, 0.3, shape),
        "normal": lambda k: prng.normal(k, shape),
    }
    line = {"phase": "prng", "keys": PRNG_KEYS, "draws_per_function": PRNG_KEYS * 1024}
    for name, fn in fns.items():
        want, got = fn(keys["cpu"]).numpy(), fn(keys[dev]).cpu().numpy()
        entry = {"elements": int(want.size)}
        if name == "normal":
            entry["max_ulp"] = _ulps(got, want)
            entry["max_abs"] = float(np.abs(got - want).max())
            if not entry["max_ulp"] <= MAX_NORMAL_ULP:
                fail(f"prng: normal on the card is {entry['max_ulp']} ulp from the CPU")
        else:
            entry["mismatches"] = int((got != want).sum())
            if entry["mismatches"]:
                fail(f"prng: {name} differs between the card and the CPU: {entry}")
        line[name] = entry
    emit(line)
    return line


def corpus_phase(dev) -> dict:
    """64 tracks of the scale corpus (30 s) built on the card and on the
    CPU from the same (seed, index) keys."""
    idx = np.arange(CORPUS_TRACKS) * 1663 % SCALE_TRACKS
    on_card = synth_tracks_device(SCALE_SEED, idx, 30 * SR, SR, device=dev)
    on_cpu = synth_tracks_device(SCALE_SEED, idx, 30 * SR, SR, device="cpu")
    err = float((on_card.cpu() - on_cpu).abs().max()) / float(on_cpu.abs().max())
    line = {"phase": "corpus_card_vs_cpu", "tracks": CORPUS_TRACKS, "seconds": 30,
            "seed": SCALE_SEED, "max_err_of_peak": err}
    emit(line)
    if not err <= MAX_CORPUS_CARD_VS_CPU:
        fail(f"corpus: the card's tracks are {err} of the peak from the CPU's")
    return line


def queries_phase(dev, noise_bank, ir_bank) -> dict:
    """The scale proof's first 64 frozen-seed-42 ``default_parameters``
    queries (plan, crops of the corpus, augmentation) made on the card and
    on the CPU with the same banks."""
    qidx, offsets = SP.query_plan(SCALE_TRACKS, QUERY_CHECK_N, 42)
    params = test_pipelines_parameters["default_parameters"]
    out = {}
    for d in (dev, torch.device("cpu")):
        fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device=d)
        fp.freeze_parameters(AUGMENT_SEED)
        (_, _, crops), = SP.condition_batches(
            SP.corpus_tracks(SCALE_SEED, d), fp, qidx, offsets, QUERY_CHECK_N)
        out[d.type] = crops.cpu()
    err = float((out["cuda"] - out["cpu"]).abs().max())
    line = {"phase": "queries_card_vs_cpu", "queries": QUERY_CHECK_N,
            "condition": "default_parameters", "seed": AUGMENT_SEED, "max_abs": err}
    emit(line)
    if not err <= MAX_QUERIES_CARD_VS_CPU:
        fail(f"queries: the card's frozen-seed crops are {err} from the CPU's")
    return line


CAP_SWEEP_TRACKS = 10_000
CAP_SWEEP_CAPS = "64,1024,inf"
CAP_SWEEP_QUERIES = 512
CAP_SWEEP_CONDITIONS = "cleans,default_parameters"
BIG_BANK_MB = 256
BIG_BANK_STEPS = 8


def cap_sweep_phase(work: str) -> dict:
    """``testing/dejavu_cap_sweep`` on a 10,000-track ingest: the rows
    dropped fall as the cap rises, the uncapped index drops none and
    identifies the clean queries (accuracy >= 0.99)."""
    cs_dir = os.path.join(work, "cap_sweep")
    flags = ("--workdir", cs_dir, "--device", "cuda")
    CS.main(["ingest", "--tracks", str(CAP_SWEEP_TRACKS), "--minutes", "60", *flags])
    with contextlib.redirect_stdout(io.StringIO()):
        report = CS.stage_sweep(CS.parser().parse_args(
            ["sweep", "--caps", CAP_SWEEP_CAPS, "--queries", str(CAP_SWEEP_QUERIES),
             "--conditions", CAP_SWEEP_CONDITIONS, *flags]))
    line = {"phase": "cap_sweep", "tracks": CAP_SWEEP_TRACKS, "queries": CAP_SWEEP_QUERIES,
            "total_rows_ingested": report["total_rows_ingested"], "caps": report["caps"]}
    emit(line)
    caps = [report["caps"][c] for c in CAP_SWEEP_CAPS.split(",")]
    dropped = [c["rows_dropped"] for c in caps]
    if dropped != sorted(dropped, reverse=True) or dropped[-1] != 0:
        fail(f"cap_sweep: rows dropped per cap {dropped}")
    if caps[-1]["conditions"]["cleans"]["accuracy"] < MIN_CLEAN_ACCURACY:
        fail(f"cap_sweep: uncapped clean accuracy {caps[-1]['conditions']['cleans']}")
    return line


def big_bank_phase(dev) -> dict:
    """``train/big_bank_train``: the base=8 UNet step, batch 32 x 3 s, with a
    256 MB noise bank against the 32-row toy bank. The bank stays the same
    tensor and is not copied per step: the step allocates no more with it
    than with the toy bank, give or take a tenth of the bank."""
    out = big_bank_train.run(BIG_BANK_MB, 32, BIG_BANK_STEPS, dev)
    line = {"phase": "big_bank", **out}
    emit(line)
    big, toy = out["big"], out["toy"]
    extra = big["allocated_mb_per_step"] - toy["allocated_mb_per_step"]
    if not abs(extra) <= 0.1 * big["bank_mb"]:
        fail(f"big_bank: {extra} MB more allocated per step with the big bank")
    return line


def scale_args(module, stage: str, workdir: str, *flags):
    return module.parser().parse_args([stage, "--workdir", workdir, "--device", "cuda", *flags])


DROPOUT_LAUNCHES: dict = {}  # the dropout kernel's launches on each training path


def dropout_counted(label: str, fn):
    """``fn()`` with the dropout kernel's counter zeroed just before and
    read just after into ``DROPOUT_LAUNCHES[label]``, which must be > 0;
    returns (result, launches)."""
    torch.cuda.synchronize()
    DROP.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    n = DROPOUT_LAUNCHES[label] = DROP.LAUNCHES["dropout_threefry"]
    if n <= 0:
        fail(f"the dropout kernel did not launch in {label}")
    return out, n


def counted(label: str, launches: dict, fn):
    """``fn()`` with the prune and hashing counters zeroed just before and
    the prune counters read just after into ``launches[label]``; returns
    the result."""
    K.reset_launch_counts()
    HC.reset_launch_counts()
    out = fn()
    launches[label] = dict(K.LAUNCHES)
    return out



def require_launches(label: str, launches: dict) -> None:
    for k, n in launches[label].items():
        if n <= 0:
            fail(f"{k} kernel did not launch in {label}")


def quiet_report(fn, args) -> str:
    """A report stage with its printed copy of the state swallowed."""
    with contextlib.redirect_stdout(io.StringIO()):
        fn(args)
    return args.out


def conditions_line(state: dict) -> dict:
    return {c: {k: v[k] for k in SCALE_MATCH_KEYS if k in v}
            for c, v in state["conditions"].items()}


def scale_phases(dev, work: str) -> dict:
    """Phases 35-43. Returns the prune launches of each path."""
    sp_dir, dj_dir = os.path.join(work, "scale_proof"), os.path.join(work, "dejavu_scale")
    launches: dict = {}
    match_flags = ("--shifts", str(SCALE_SHIFTS), "--banks", "dcase")

    # ---- 35. scale_ingest: two invocations, the second resumes the first
    def ingest():
        SP.stage_ingest(scale_args(SP, "ingest", sp_dir, "--minutes", str(SCALE_FIRST_MINUTES)))
        first = SP.load_state(sp_dir).get("next_track", 0)
        SP.stage_ingest(scale_args(SP, "ingest", sp_dir, "--minutes", "60"))
        return first

    first = counted("scale_ingest", launches, ingest)
    state = SP.load_state(sp_dir)
    emit({"phase": "scale_ingest", "tracks": SCALE_TRACKS, "batch": SCALE_BATCH,
          "invocations": 2, "first_invocation_tracks": first,
          **{k: state.get(k) for k in SCALE_INGEST_STATS}, "launches": launches["scale_ingest"]})
    if not state.get("ingest_done") or not 0 < first < SCALE_TRACKS:
        fail(f"scale_ingest: done {state.get('ingest_done')}, first invocation {first} tracks")
    if not state["buckets_over_depth"] > 0 or state["hash_overflow"]:
        fail(f"scale_ingest: the table did not saturate or a track overflowed: {state}")
    require_launches("scale_ingest", launches)

    # ---- 36. scale_match: the 11 conditions, then the UNet and Demucs arms
    counted("scale_match", launches, lambda: SP.stage_match(scale_args(
        SP, "match", sp_dir, "--queries", str(SCALE_QUERIES), *match_flags)))
    state = SP.load_state(sp_dir)
    emit({"phase": "scale_match", "queries": SCALE_QUERIES, "shifts": SCALE_SHIFTS,
          "batch": SCALE_BATCH, "eff_depth": state["eff_depth"],
          "conditions": conditions_line(state), "launches": launches["scale_match"]})
    if len(state["conditions"]) != 11:
        fail(f"scale_match ran {sorted(state['conditions'])}")
    if state["conditions"]["cleans"]["accuracy"] < MIN_CLEAN_ACCURACY:
        fail(f"scale_match: clean accuracy {state['conditions']['cleans']['accuracy']}")
    require_launches("scale_match", launches)
    hashes_counted("scale_match")

    for model, flags, queries, conds in (
        ("unet", (), SCALE_DENOISED_QUERIES, "cleans,default_parameters"),
        ("demucs", ("--train-batch", str(SCALE_DEMUCS_TRAIN_BATCH)), SCALE_DEMUCS_QUERIES, "bn_m10"),
    ):
        train = lambda: SP.stage_train(scale_args(  # noqa: E731
            SP, "train", sp_dir, "--model", model, "--banks", "dcase", *SCALE_TRAIN, *flags))
        if model == "unet":
            dropout_counted("scale_unet_train", train)
        else:
            train()
        label = f"scale_{model}_denoised"
        counted(label, launches, lambda: SP.stage_match(scale_args(
            SP, "match", sp_dir, "--queries", str(queries), "--conditions", conds, "--denoise",
            "--denoise-model", model, *match_flags)))
        state = SP.load_state(sp_dir)
        key = "denoiser_train" if model == "unet" else "denoiser_train_demucs"
        line = conditions_line(state)
        emit({"phase": label, "checkpoint": f"scale_proof train, {model}, 2 epochs x 4 steps",
              "train": state[key], "queries": queries,
              "conditions": {c: line[c] for c in conds.split(",")}, "launches": launches[label]})
        sfx = "" if model == "unet" else "_demucs"
        for c in conds.split(","):
            row = state["conditions"][c]
            if row["n_queries"] != queries or not all(
                    0.0 <= row[k + sfx] <= 1.0 for k in ("accuracy_den", "accuracy_mix")):
                fail(f"{label}: {c} {row}")
        require_launches(label, launches)
        hashes_counted(label)
    if state["conditions"]["cleans"]["accuracy_mix"] < MIN_CLEAN_ACCURACY:
        fail(f"scale_unet_denoised: clean mix accuracy {state['conditions']['cleans']}")

    # ---- 37. scale_oracle and 38. scale_peaks
    counted("scale_oracle", launches, lambda: SP.stage_oracle(scale_args(
        SP, "oracle", sp_dir, *match_flags, "--oracle-n", str(SCALE_ORACLE_N))))
    state = SP.load_state(sp_dir)
    emit({"phase": "scale_oracle", "queries": SCALE_ORACLE_N, "shifts": SCALE_SHIFTS,
          "agreement": state["oracle_agreement"], "launches": launches["scale_oracle"]})
    if state["oracle_agreement"] != f"{SCALE_ORACLE_N}/{SCALE_ORACLE_N}":
        fail(f"scale_oracle: {state['oracle_agreement']}")
    counted("scale_peaks", launches, lambda: SP.stage_peaks(scale_args(
        SP, "peaks", sp_dir, "--queries", str(SCALE_PEAKS_QUERIES), "--banks", "dcase")))
    state = SP.load_state(sp_dir)
    peaks = {c: {k: v[k] for k in v if k.startswith(("peaks_", "psnr_"))}
             for c, v in state["conditions"].items() if c != "cleans"}
    emit({"phase": "scale_peaks", "queries": SCALE_PEAKS_QUERIES,
          "conditions": peaks, "launches": launches["scale_peaks"]})
    if len(peaks) != 10 or not all(math.isfinite(x) for row in peaks.values() for x in row.values()):
        fail(f"scale_peaks: {peaks}")
    report = quiet_report(SP.stage_report, scale_args(
        SP, "report", sp_dir, "--out", os.path.join(work, "results.json")))
    with open(report) as f:
        emit({"phase": "scale_report", "keys": sorted(json.load(f))})
    require_launches("scale_oracle", launches)
    require_launches("scale_peaks", launches)

    # ---- 39-41. Dejavu on the same corpus: no prune kernel on its path
    prune_before = dict(K.LAUNCHES)
    DS.stage_ingest(scale_args(DS, "ingest", dj_dir, "--minutes", "60"))
    dj_flags = ("--banks", "dcase")
    # one load and finalize of the 70M-row index, shared by the match, the
    # UNet arm and the oracle (each stage run alone does its own)
    dj_index = DS.load_index(dj_dir)
    dj_index.finalize()
    DS.stage_match(scale_args(DS, "match", dj_dir, "--queries", str(SCALE_QUERIES), *dj_flags),
                   index=dj_index)
    state = DS.load_state(dj_dir)
    emit({"phase": "dejavu_scale_ingest", "tracks": SCALE_TRACKS, "hash_cap": state["hash_cap"],
          **{k: state.get(k) for k in DJ_SCALE_KEYS},
          "finalize_shared_by": ["match", "unet_denoised", "oracle"]})
    emit({"phase": "dejavu_scale_match", "queries": SCALE_QUERIES,
          "conditions": conditions_line(state)})
    if state["conditions"]["cleans"]["accuracy"] < MIN_CLEAN_ACCURACY:
        fail(f"dejavu_scale_match: clean accuracy {state['conditions']['cleans']['accuracy']}")
    DS.stage_match(scale_args(DS, "match", dj_dir, "--queries", str(SCALE_DENOISED_QUERIES),
                              "--conditions", "cleans,default_parameters", "--denoise", "--rerun",
                              "--unet-pkl", os.path.join(sp_dir, "unet.pt"), *dj_flags),
                   index=dj_index)
    state = DS.load_state(dj_dir)
    line = conditions_line(state)
    emit({"phase": "dejavu_scale_unet_denoised", "checkpoint": "scale_proof train, unet",
          "queries": SCALE_DENOISED_QUERIES,
          "conditions": {c: line[c] for c in ("cleans", "default_parameters")}})
    DS.stage_oracle(scale_args(DS, "oracle", dj_dir, *dj_flags, "--oracle-n", str(SCALE_ORACLE_N)),
                    index=dj_index)
    del dj_index
    state = DS.load_state(dj_dir)
    quiet_report(DS.stage_report, scale_args(
        DS, "report", dj_dir, "--out", os.path.join(work, "dejavu_results.json")))
    emit({"phase": "dejavu_scale_oracle", "queries": SCALE_ORACLE_N,
          "agreement": state["oracle_agreement"],
          "prune_launches_before": prune_before, "prune_launches_after": dict(K.LAUNCHES)})
    if state["oracle_agreement"] != f"{SCALE_ORACLE_N}/{SCALE_ORACLE_N}":
        fail(f"dejavu_scale_oracle: {state['oracle_agreement']}")
    cap_sweep_phase(work)
    if dict(K.LAUNCHES) != prune_before:
        fail("the Dejavu scale phases launched a prune kernel")

    # ---- 42. the end-to-end demo at its quick size
    out_dir = os.path.join(work, "demo")
    demo, _ = dropout_counted("demo", lambda: counted(
        "demo", launches, lambda: full_pipeline_demo.main([*DEMO_ARGS, "--out", out_dir])))
    emit({"phase": "full_pipeline_demo", "args": list(DEMO_ARGS),

          "train_val_loss": demo["train_val_loss"],
          "accuracy": {c: demo[c]["accuracy"] for c in ("cleans", "bn_0", "full_hard", "reverb")},
          "f1": {c: [demo[c]["peaks"]["f1_score_no_den"], demo[c]["peaks"]["f1_den"]]
                 for c in ("bn_0", "full_hard", "reverb")},
          "launches": launches["demo"]})
    if demo["cleans"]["accuracy"]["No Denoising"] < MIN_CLEAN_ACCURACY:
        fail(f"full_pipeline_demo: {demo['cleans']}")
    require_launches("demo", launches)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    dev = torch.device("cuda")

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # host work that needs neither the kernels nor the card runs beside the
    # phases that do: nvcc, and the host numpy of the banks of phase 6
    pool = cf.ThreadPoolExecutor(3)
    building = pool.submit(_build.build, verbose=True)
    banking = pool.submit(dcase_shaped_banks, hours=BANK_HOURS, device="cpu")
    pool.submit(training_batches)  # cached: the training phases take them from there

    # ---- 2a. prng and 2b. the corpus: the card's draws are the CPU's
    prng_phase(dev)
    corpus_phase(dev)

    # ---- 2. build
    lib = building.result()
    _build.library()
    emit({"phase": "build", "library": lib})

    # ---- corpus and queries (set-up, on the card)
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
    # a batch of the reference-scale ingest: 128 tracks of 30 s, 938 columns
    scale_waves = SP.corpus_tracks(SCALE_SEED, dev)(np.arange(SCALE_BATCH))
    x_scale = P.prune_input(scale_waves)
    if tuple(x_scale.shape) != (SCALE_BATCH, 256, 938):
        fail(f"unexpected scale ingest shape {tuple(x_scale.shape)}")
    at_query = check_kernels("query", x_query, None)
    at_stacked = check_kernels("stacked", x_stacked, vf_stacked)
    at_ingest = check_kernels("ingest", x_ingest, vf_ing)
    at_scale = check_kernels("scale_ingest", x_scale, None)
    del x_scale, x_ingest
    emit({"phase": "kernels", "query": at_query, "stacked": at_stacked,
          "ingest": at_ingest, "scale_ingest": at_scale})

    # ---- 3a. the dropout kernel at the training shape
    at_train = flax_init_dropout_phase(dev)

    # ---- 3b. the hashing kernel vs the plain chain: 8 s and 30 s x 4 shifts
    # at the matcher's budget, and an ingest batch in one shift at the budget
    # hashes_batch gives it
    at_hash = hash_stage_check(dev, {
        "query": (q_batch, SHIFTS, 4096, None),  # match_waveforms' max_query_hashes
        "long_30s": (scale_waves, SHIFTS, 4096, None),
        "ingest": (ing, 1, None, valid),
    })
    emit({"phase": "hash_stage", **at_hash})
    del scale_waves, ing

    # ---- 3c. the rotary kernel vs the plain chain at BS-RoFormer's shapes
    emit({"phase": "rope_qk", **rope_check(dev)})

    # ---- 4. ingest (launch counters zeroed just before the main path): the
    # hashing kernel once a batch
    K.reset_launch_counts()
    HC.reset_launch_counts()
    analyzer = AudfprintPeaks(afp_settings["audfprint"], device=dev)
    ht = create_fp_database(
        tracks, None, analyzer=analyzer, batch_size=INGEST_BATCH,
        hash_tab=HashTable(), names=names, device=dev,
    )
    launches_ingest = dict(K.LAUNCHES)
    hashes_counted("ingest", -(-N_TRACKS // INGEST_BATCH))
    dm = DeviceMatcher(ht, device=dev)
    emit({
        "phase": "ingest", "tracks": N_TRACKS, "total_hashes": ht.totalhashes(),
        "table": [int(1 << ht.hashbits), int(ht.depth)], "eff_depth": dm.eff_depth,
        "launches": launches_ingest,
    })
    if (ht.table.shape != (1 << 20, 100)) or len(ht.names) != N_TRACKS:
        fail("the ingest did not fill a 2^20 x 100 table with every track")

    # ---- 5. match
    HC.reset_launch_counts()
    acc = compute_accuracy_batched(
        queries, ht, analyzer, batch_size=QUERY_BATCH, shifts=SHIFTS,
        device_matcher=dm, names=[names[int(t)] for t in q_ids], device=dev,
    )
    unseen_v = dm.match_waveforms(unseen, shifts=SHIFTS)
    launches = dict(K.LAUNCHES)
    launches_match = {k: launches[k] - launches_ingest[k] for k in launches}
    hashes_counted("match", N_QUERIES // QUERY_BATCH + 1)  # the batches, the unseen batch
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
        "unseen_queries": N_UNSEEN, "unseen_nomatch_rate": nomatch, "launches": launches_match,
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
    noise_bank, ir_bank = banking.result()
    pool.shutdown()
    noise_bank, ir_bank = noise_bank.to(dev), ir_bank.to(dev)
    emit({"phase": "banks", "hours": BANK_HOURS, "noise_rows": noise_bank.num_clips,
          "scenes": int(noise_bank.scene_starts.shape[0]), "irs": ir_bank.num_irs})

    # ---- 7. augment: the 1,024 clean crops under the 10 conditions
    K.reset_launch_counts()
    clean = torch.stack(queries)
    augmented, snr_err = {}, {}
    for cond, params in test_pipelines_parameters.items():
        fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device=dev)
        augmented[cond] = augment_condition(fp, clean)
        check_augmented(cond, fp, clean, augmented[cond])
        if cond.startswith("bn_"):
            err = snr_err[cond] = snr_error_db(
                fp, clean[:AUGMENT_BATCH], augmented[cond][:AUGMENT_BATCH])
            if not err <= MAX_SNR_ERR_DB:
                fail(f"{cond}: the mix is {err} dB away from the drawn SNR")
    # the card against the CPU on the same draws, and the direct filter route
    default = test_pipelines_parameters["default_parameters"]
    on_card = AugmentFP(noise_bank, SR, parameters=default, impulse_response_dir=ir_bank, device=dev)
    on_cpu = AugmentFP(noise_bank, SR, parameters=default, impulse_response_dir=ir_bank, device="cpu")
    draws16 = on_card.draw_indexed(range(16), clean.shape[-1], prng.key(AUGMENT_SEED))
    card_vs_cpu = float(
        (on_card.apply(clean[:16], draws16).cpu() - on_cpu.apply(clean[:16].cpu(), draws16)).abs().max())
    del on_card, on_cpu
    emit({"phase": "augment", "examples": N_QUERIES, "batch": AUGMENT_BATCH,
          "seed": AUGMENT_SEED, "conditions": sorted(augmented), "snr_err_db": snr_err,
          "card_vs_cpu_max_abs": card_vs_cpu, "card_vs_cpu_examples": 16})
    if not card_vs_cpu <= MAX_CARD_VS_CPU:
        fail(f"the chain on the card is {card_vs_cpu} away from the CPU on the same draws")
    check_conv_route(dev)
    # ---- 7a. the frozen-seed queries made on the card and on the CPU
    queries_phase(dev, noise_bank, ir_bank)

    # ---- 8. conditions: identify every condition's queries
    q_names = [names[int(t)] for t in q_ids]
    accuracy = {"cleans": acc["No Denoising"]}
    HC.reset_launch_counts()
    for cond, out in augmented.items():
        accuracy[cond] = compute_accuracy_batched(
            list(out), ht, analyzer, batch_size=QUERY_BATCH, shifts=SHIFTS,
            device_matcher=dm, names=q_names, device=dev,
        )["No Denoising"]
    launches_conditions = dict(K.LAUNCHES)
    hashes_counted("conditions", len(augmented) * (N_QUERIES // QUERY_BATCH))
    emit({"phase": "conditions", "queries": N_QUERIES, "shifts": SHIFTS,
          "accuracy": accuracy, "launches": launches_conditions})
    for cond, floor in MIN_ACCURACY.items():
        if accuracy[cond] < floor:
            fail(f"{cond} accuracy {accuracy[cond]} < {floor}")
    if accuracy["bn_m10"] > accuracy["bn_p10"]:
        fail("more noise (bn_m10) identified better than less (bn_p10)")
    for k, n in launches_conditions.items():
        if n <= 0:
            fail(f"{k} kernel did not launch while the conditions were identified")
    aug_default = augmented["default_parameters"][:DENOISED_QUERIES].clone()
    augmented_host = {cond: out.cpu() for cond, out in augmented.items()}  # for Dejavu
    del augmented

    # ---- 10. the UNet at full width, card against CPU
    unet_phase(dev, P.spectrogram_frontend(aug_default[:UNET_BATCH]))

    # ---- 11. denoised: both analyzers through compute_accuracy_batched
    hook = unet_denoiser(make_identity_unet(UNet(1, 1)).to(dev))
    analyzer_den = AudfprintPeaks(
        afp_settings["audfprint"], denoising=True, denoising_model="unet",
        spec_denoiser=hook, device=dev,
    )
    aug_batch = aug_default[:QUERY_BATCH]
    # one batch's masks with and without the hook
    masks_plain = P.find_peaks_batch(aug_batch)
    masks_den = P.find_peaks_batch(aug_batch, denoiser=hook)
    agreement = float((masks_plain == masks_den).float().mean())
    K.reset_launch_counts()
    HC.reset_launch_counts()
    den_names = q_names[:DENOISED_QUERIES]
    denoised = {}
    for label, qs in (("cleans", queries[:DENOISED_QUERIES]),
                      ("default_parameters", list(aug_default))):
        denoised[label] = compute_accuracy_batched(
            qs, ht, analyzer, analyzer_den, batch_size=QUERY_BATCH, shifts=SHIFTS,
            device_matcher=dm, names=den_names, device=dev,
        )
    launches_denoised = dict(K.LAUNCHES)
    hashes_counted("denoised", 2 * 2 * (DENOISED_QUERIES // QUERY_BATCH))  # 2 sets x 2 arms
    emit({"phase": "denoised", "queries": DENOISED_QUERIES, "shifts": SHIFTS,
          "unet": "base=64, identity weights", "accuracy": denoised,
          "mask_agreement": agreement, "launches": launches_denoised})
    for label, a in denoised.items():
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
    metrics = compute_peaks_metrics_batched(
        q_paths, analyzer, analyzer_den, cleans_path=os.path.join(tmp, "cleans"))
    launches_metrics = dict(K.LAUNCHES)
    emit({"phase": "peaks_metrics", "queries": DENOISED_QUERIES, "metrics": metrics,
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
    del hook, analyzer_den, masks_plain, masks_den
    torch.cuda.empty_cache()

    # ---- 13-15. training: one step card against CPU, the published UNet
    # trained in two precisions with a resume, then the trained checkpoint
    # as the denoiser of phases 11 and 12
    train_step_check(dev)
    unet_ckpt_dir = tempfile.TemporaryDirectory()  # kept for phase 33
    ckpt_path, _ = dropout_counted("train", lambda: train_phase(
        dev, noise_bank, ir_bank, unet_ckpt_dir.name))
    trained = trained_denoiser_phase(
        dev, ckpt_path, ht, dm, analyzer, queries, aug_default, den_names, q_paths,
        os.path.join(tmp, "cleans"))
    launches_trained = trained["launches"]
    del trained
    torch.cuda.empty_cache()

    # ---- 16-21. Demucs: the published model, as the waveform denoiser of
    # the identification and the peak metrics, one train step card against
    # CPU, training in two precisions, the trained checkpoint as the
    # denoiser, streaming
    cleans_dir = os.path.join(tmp, "cleans")
    demucs = demucs_phase(dev, aug_default[:DEMUCS_BATCH])
    seeded_den = demucs_denoised_phase("seeded", demucs, ht, dm, analyzer, queries, aug_default,
                                       den_names, q_paths, cleans_dir)
    del demucs
    torch.cuda.empty_cache()
    demucs_train_step_check(dev)
    ckpt_dir = tempfile.TemporaryDirectory()
    best = demucs_train_phase(dev, noise_bank, ir_bank, ckpt_dir.name)
    trained_demucs = Demucs().to(dev)
    trained_demucs.load_state_dict(torch.load(best, map_location=dev, weights_only=True)["model"])
    trained_den = demucs_denoised_phase("trained: demucs_train float32 best_epoch", trained_demucs, ht, dm,
                                        analyzer, queries, aug_default, den_names, q_paths, cleans_dir)
    del trained_demucs
    ckpt_dir.cleanup()
    streamer_phase(dev)

    # ---- 22-28. Dejavu, whose path reaches no prune kernel
    prune_before = dict(K.LAUNCHES)
    dj_idx = dejavu_phases(dev, tracks, lengths, names, queries, q_ids, q_offs, unseen,
                           augmented_host, q_paths, cleans_dir, tmp)
    emit({"phase": "dejavu_phases", "prune_launches_before": prune_before,
          "prune_launches_after": dict(K.LAUNCHES)})
    if dict(K.LAUNCHES) != prune_before:
        fail(f"the Dejavu phases launched a prune kernel: {prune_before} -> {dict(K.LAUNCHES)}")
    del augmented_host

    # ---- 30-34. the native decoders, the FMA selection indexed and
    # identified from mp3 paths, the parallel layer, monitoring and the CQT
    # loss, the demo CLI, the app
    io_line = native_io_phase()
    launches_fma = fma_eval_phase(dev, tmp, io_line)
    launches_mesh, _ = dropout_counted("parallel", lambda: parallel_phase(
        dev, noise_bank, ir_bank, queries, ht, dm, dj_idx))
    monitoring_phase(dev, noise_bank, ir_bank, unet_ckpt_dir.name, tmp)
    unet_ckpt_dir.cleanup()
    app_phase(dev)
    tmp_dir.cleanup()

    # ---- 35-42. the reference-scale proofs and the end-to-end demo
    del tracks, unseen_tracks, queries, unseen, aug_default
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        launches_scale = scale_phases(dev, work)

    # ---- 44. the training step with a 256 MB noise bank
    dropout_counted("big_bank", lambda: big_bank_phase(dev))

    kernels = []
    for kname, line in (("forward_prune", 60), ("backward_prune", 113)):
        q, i, st, sc = at_query[kname], at_ingest[kname], at_stacked[kname], at_scale[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "musicfpaugment_torch/csrc/peaks_prune.cu",
            "replaces": f"musicfpaugment_tpu/afp/audfprint/peaks_pallas.py:{line}",
            "launches": launches[kname] + launches_conditions[kname]
            + launches_denoised[kname] + launches_metrics[kname] + launches_trained[kname]
            + seeded_den["launches"][kname] + trained_den["launches"][kname]
            + launches_fma["index"][kname] + launches_fma["identify"][kname] + launches_mesh[kname]
            + sum(n[kname] for n in launches_scale.values()),
            "launches_ingest": launches_ingest[kname],
            "launches_match": launches_match[kname],
            "launches_conditions": launches_conditions[kname],
            "launches_denoised": launches_denoised[kname],
            "launches_peaks_metrics": launches_metrics[kname],
            "launches_trained_denoiser": launches_trained[kname],
            "launches_demucs_denoised": seeded_den["launches"][kname],
            "launches_demucs_trained": trained_den["launches"][kname],
            "launches_fma_index": launches_fma["index"][kname],
            "launches_fma_identify": launches_fma["identify"][kname],
            "launches_mesh_match": launches_mesh[kname],
            **{f"launches_{label}": n[kname] for label, n in launches_scale.items()},
            "ms": st["kernel_ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": None, "shape": "stacked",
            "kernel_ms": st["kernel_ms"], "wrapper_ms": st["ms"],
            "query_kernel_ms": q["kernel_ms"], "query_wrapper_ms": q["ms"],
            "query_plain_ms": q["plain_ms"], "query_bound_ms": q["bound_ms"],
            "ingest_kernel_ms": i["kernel_ms"], "ingest_wrapper_ms": i["ms"],
            "ingest_plain_ms": i["plain_ms"], "ingest_bound_ms": i["bound_ms"],
            "scale_ingest_kernel_ms": sc["kernel_ms"], "scale_ingest_wrapper_ms": sc["ms"],
            "scale_ingest_plain_ms": sc["plain_ms"], "scale_ingest_bound_ms": sc["bound_ms"],
            "scale_ingest_bound_by": sc["bound_by"],
        })
    drop_f32, drop_bf16 = at_train["step_forward"]["float32"], at_train["step_forward"]["bfloat16"]
    kernels.append({
        "name": "dropout_threefry", "route": "cuda",
        "source": "musicfpaugment_torch/csrc/dropout_threefry.cu",
        # no Pallas kernel: XLA generates the JAX UNet's flax.linen.Dropout
        "replaces": "musicfpaugment_tpu/models/unet.py:115",
        "launches": sum(DROPOUT_LAUNCHES.values()),
        **{f"launches_{label}": n for label, n in DROPOUT_LAUNCHES.items()},
        "launches_per_train_step": at_train["launches_per_train_step"],
        "ms": drop_bf16["ms"], "plain_ms": drop_bf16["plain_ms"],
        "bound_ms": drop_bf16["bound_ms"], "bound_by": drop_bf16["bound_by"], "library_ms": None,
        "shape": "the five sites of one bfloat16 training step's forward, 128 x 3 s, base 64",
        "float32_ms": drop_f32["ms"], "float32_plain_ms": drop_f32["plain_ms"],
        "float32_bound_ms": drop_f32["bound_ms"], "float32_bound_by": drop_f32["bound_by"],
        "torch_dropout_ms_other_masks": drop_bf16["torch_dropout_ms"],
    })
    hq, hl, hi = at_hash["query"], at_hash["long_30s"], at_hash["ingest"]
    kernels.append({
        "name": "union_hashes", "route": "cuda",
        "source": "musicfpaugment_torch/csrc/union_hashes.cu",
        # no Pallas kernel: XLA generates the JAX package's hashing stage
        "replaces": "musicfpaugment_tpu/afp/audfprint/landmarks.py:255",
        "launches": sum(HASH_LAUNCHES.values()),
        **{f"launches_{label}": n for label, n in HASH_LAUNCHES.items()},
        "mismatch_rows": hq["mismatch_rows"] + hl["mismatch_rows"] + hi["mismatch_rows"],
        "ms": hq["kernel_ms"], "bound_ms": hq["bound_ms"], "bound_by": "bytes",
        # the plain version is the PyTorch chain the kernel replaced
        "plain_ms": hq["library_ms"], "library_ms": hq["library_ms"], "shape": "query",
        "long_30s_ms": hl["kernel_ms"], "long_30s_bound_ms": hl["bound_ms"],
        "long_30s_library_ms": hl["library_ms"],
        "ingest_ms": hi["kernel_ms"], "ingest_bound_ms": hi["bound_ms"],
        "ingest_library_ms": hi["library_ms"], "ingest_out_len": hi["out_len"],
    })
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    main()

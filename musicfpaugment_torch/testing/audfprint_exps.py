"""Audfprint evaluation harness and CLI (port of
musicfpaugment_tpu/testing/audfprint_exps.py).

Actions: ``identification_rate`` (accuracy over the condition directories,
no-denoise / denoise / mix-pipeline), ``peaks_metrics`` (peak P/R/F1 and
spectrogram PSNR of augmented and denoised queries against the clean ones).
``index`` waits for ``testing/fma_preprocessing.py``; ``create_fp_database``
indexes any list of inputs.

Inputs are arrays, tensors (kept on their device) or ``.npy``, ``.pkl`` and
``.wav`` paths; a ``names`` list gives the names to index under and the
ground truth to score against when the inputs are not paths. Analyzers and
denoisers are injected; results go to ``RESULTS_DIR/*.json``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint.analyzer import (
    AudfprintPeaks,
    pad_waveform_batch,
)
from musicfpaugment_torch.afp.audfprint.hash_table import HashTable
from musicfpaugment_torch.afp.audfprint.matcher import Matcher
from musicfpaugment_torch.afp.audfprint.matcher_device import DeviceMatcher
from musicfpaugment_torch.device import DeviceLike, resolve_device
from musicfpaugment_torch.testing.metrics import (
    F1score,
    Precision,
    Recall,
    batch_peak_metrics,
    batch_psnr,
    psnr,
)
from musicfpaugment_torch.testing.parameters import (
    afp_db_paths,
    afp_settings,
    queries_paths,
)

RESULTS_DIR = os.environ.get(
    "MFPA_RESULTS_DIR", os.path.join(os.path.dirname(__file__), "results")
)


def _analyzer_for(analyzer: Optional[AudfprintPeaks], device: DeviceLike) -> AudfprintPeaks:
    device = resolve_device(device)
    if analyzer is None:
        return AudfprintPeaks(afp_settings["audfprint"], device=device)
    if analyzer.device != device:
        raise ValueError(f"analyzer is on {analyzer.device}, not {device}")
    return analyzer


def _stack(wavs, n_fft: int, device, bucket: Optional[int] = None):
    """(batch, valid_samples or None): uniform lengths stack as they are;
    mixed lengths are reflect-padded (to a multiple of ``bucket`` samples,
    if given) with per-example validity."""
    lens = {int(w.shape[0]) for w in wavs}
    if len(lens) == 1:
        if isinstance(wavs[0], torch.Tensor):
            return torch.stack([w.to(device) for w in wavs]), None
        return torch.from_numpy(np.stack(wavs)).to(device), None
    pad_to = None if bucket is None else -(-max(lens) // bucket) * bucket
    return pad_waveform_batch(wavs, n_fft=n_fft, pad_to=pad_to, device=device)


def create_fp_database(
    files: Sequence,
    dbpath: Optional[str],
    analyzer: Optional[AudfprintPeaks] = None,
    batch_size: int = 64,
    hash_tab: Optional[HashTable] = None,
    names: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
) -> HashTable:
    """Bulk-index a corpus into the hash table.

    Each batch's peaks and landmark hashes run on the device through
    ``ingest_batch`` (one shift), and each track is stored by one
    vectorized numpy scatter. Mixed-length batches are reflect-padded with
    validity masking; lengths are bucketed to 2-second steps. Inputs that
    fail to load print and are skipped. Returns the table (also saved to
    ``dbpath`` unless it is None)."""
    analyzer = _analyzer_for(analyzer, device)
    hash_tab = hash_tab if hash_tab is not None else HashTable()
    names = list(names) if names is not None else [str(f) for f in files]
    if len(names) != len(files):
        raise ValueError("names and files differ in length")
    bucket = 2 * analyzer.target_sr
    for start in range(0, len(files), batch_size):
        good = []
        for i in range(start, min(start + batch_size, len(files))):
            try:
                w = analyzer._load(files[i])
            except (OSError, ValueError) as exc:
                print("error with ", names[i], exc)
                continue
            if w.shape[0]:
                good.append((names[i], w))
        if good:
            batch, valid = _stack(
                [w for _, w in good], analyzer.n_fft, analyzer.device, bucket
            )
            analyzer.ingest_batch(
                hash_tab, [n for n, _ in good], batch, shifts=1, valid_samples=valid
            )
    if dbpath is not None:
        hash_tab.save(dbpath)
    return hash_tab


def _ground_truth(name) -> str:
    return str(name).split("/")[-1].split(".")[0]


def _check_devices(device: DeviceLike, *analyzers) -> torch.device:
    device = resolve_device(device)
    for a in analyzers:
        if a is not None and a.device != device:
            raise ValueError(f"analyzer is on {a.device}, not {device}")
    return device


def _accuracies(n: int, correct, acc_mix: int, two: bool) -> Dict[str, float]:
    out = {"No Denoising": correct[0] / max(n, 1)}
    if two:
        out["With Denoising"] = correct[1] / max(n, 1)
        out["Mix Pipeline"] = acc_mix / max(n, 1)
    return out


def _score(gt: str, verdicts, correct) -> int:
    """Count one query's verdicts (one per analyzer) into ``correct``;
    returns 1 if the mix rule (the verdict of whichever analyzer aligned
    more hashes, the first on a tie) is right, else 0."""
    preds = []
    for ai, (status, name, aligned) in enumerate(verdicts):
        pred = _ground_truth(name)
        preds.append((status, pred, aligned))
        if status == "MATCH" and pred == gt:
            correct[ai] += 1
    if len(preds) == 2:
        best = preds[0] if preds[0][2] >= preds[1][2] else preds[1]
        return int(best[0] == "MATCH" and best[1] == gt)
    return 0


def compute_accuracy(
    files: Sequence,
    dbpath,
    analyzer1: AudfprintPeaks,
    analyzer2: Optional[AudfprintPeaks] = None,
    names: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """No-denoise / denoise / mix-rule accuracy, one query at a time through
    the numpy :class:`Matcher`: the sequential oracle of
    :func:`compute_accuracy_batched`."""
    _check_devices(device, analyzer1, analyzer2)
    hash_tab = dbpath if isinstance(dbpath, HashTable) else HashTable(dbpath)
    matcher = Matcher()
    names = list(names) if names is not None else [str(f) for f in files]
    analyzers = [analyzer1] + ([analyzer2] if analyzer2 is not None else [])
    correct = [0 for _ in analyzers]
    acc_mix = 0
    for f, name in zip(files, names):
        verdicts = [matcher.file_match_to_msgs(a, hash_tab, f) for a in analyzers]
        acc_mix += _score(_ground_truth(name), verdicts, correct)
    return _accuracies(len(files), correct, acc_mix, analyzer2 is not None)


def compute_accuracy_batched(
    files: Sequence,
    dbpath,
    analyzer1: AudfprintPeaks,
    analyzer2: Optional[AudfprintPeaks] = None,
    batch_size: int = 128,
    shifts: int = 4,
    use_device_matcher: bool = True,
    device_matcher: Optional[DeviceMatcher] = None,
    names: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Accuracy over query waveforms, per analyzer, plus the mix rule with
    two analyzers (the verdict of whichever analyzer aligned more hashes).
    Each batch goes through :meth:`DeviceMatcher.match_waveforms` once per
    analyzer, a denoising analyzer's spectrogram hook inside it and its
    waveform denoiser before it; ``use_device_matcher=False`` matches the
    analyzer's ``hashes_batch`` through the numpy :class:`Matcher` oracle
    (a prebuilt ``device_matcher`` is then not consulted). ``names`` are the
    ground truths when ``files`` are not paths; pass a prebuilt
    ``device_matcher`` to reuse its device-resident table."""
    device = _check_devices(device, analyzer1, analyzer2)
    hash_tab = dbpath if isinstance(dbpath, HashTable) else HashTable(dbpath)
    if not use_device_matcher:
        device_matcher = None
        matcher = Matcher()
    elif device_matcher is None:
        device_matcher = DeviceMatcher(hash_tab, device=device)
    names = list(names) if names is not None else [str(f) for f in files]
    analyzers = [analyzer1] + ([analyzer2] if analyzer2 is not None else [])
    correct = [0 for _ in analyzers]
    acc_mix = 0
    n = 0
    for start in range(0, len(files), batch_size):
        wavs, gts = [], []
        for i in range(start, min(start + batch_size, len(files))):
            try:
                wavs.append(analyzer1._load(files[i]))
            except (OSError, ValueError) as exc:
                print("error with ", names[i], exc)
                continue
            gts.append(_ground_truth(names[i]))
        if not wavs:
            continue
        batch, valid_samples = _stack(wavs, analyzer1.n_fft, device)
        per_analyzer = []
        for a in analyzers:
            if device_matcher is None:
                hashes_list = a.hashes_batch(batch, shifts=shifts, valid_samples=valid_samples)
                per_analyzer.append(
                    [matcher.hashes_match_to_msgs(hash_tab, qh) for qh in hashes_list]
                )
                continue
            per_analyzer.append(
                device_matcher.match_waveforms(
                    a._as_batch(batch),  # through the waveform denoiser, if any
                    shifts=shifts,
                    density=a.density,
                    n_fft=a.n_fft,
                    n_hop=a.n_hop,
                    f_sd=a.f_sd,
                    maxpksperframe=a.maxpksperframe,
                    denoiser=a._spec_hook(),
                    valid_samples=valid_samples,
                )
            )
        for qi, gt in enumerate(gts):
            n += 1
            acc_mix += _score(gt, [msgs[qi] for msgs in per_analyzer], correct)
    return _accuracies(n, correct, acc_mix, analyzer2 is not None)


PEAKS_METRICS = (
    "precision_no_den", "recall_no_den", "f1_score_no_den", "psnr_no_den_spec",
    "prec_den", "rec_den", "f1_den", "psnr_den_spec",
)


def _clean_of(query_path, cleans_path: str) -> str:
    return os.path.join(cleans_path, str(query_path).split("/")[-1])


def compute_peaks_metrics(
    queries_augmented: Sequence[str],
    analyzer_no_den: AudfprintPeaks,
    analyzer_den: AudfprintPeaks,
    cleans_path: Optional[str] = None,
) -> Dict[str, float]:
    """Peak precision / recall / F1 and spectrogram PSNR of the augmented
    queries and of the same queries denoised, each against the clean query
    of the same file name under ``cleans_path``, one file at a time: three
    ``wavfile2peaks`` calls per query, means over the queries."""
    _check_devices(analyzer_no_den.device, analyzer_den)
    cleans_path = cleans_path or queries_paths["cleans"]
    precision, recall, f1_score = Precision(), Recall(), F1score()
    acc = {k: 0.0 for k in PEAKS_METRICS}
    for qpath in queries_augmented:
        m_clean, _, sgram_clean = analyzer_no_den.wavfile2peaks(
            _clean_of(qpath, cleans_path), get_masks_waveforms=True
        )
        m_aug, _, sgram_aug = analyzer_no_den.wavfile2peaks(qpath, get_masks_waveforms=True)
        m_den, _, sgram_den = analyzer_den.wavfile2peaks(qpath, get_masks_waveforms=True)
        mc, ma, md = m_clean.T[None], m_aug.T[None], m_den.T[None]
        acc["precision_no_den"] += precision(ma, mc)
        acc["prec_den"] += precision(md, mc)
        acc["recall_no_den"] += recall(ma, mc)
        acc["rec_den"] += recall(md, mc)
        acc["f1_score_no_den"] += f1_score(ma, mc)
        acc["f1_den"] += f1_score(md, mc)
        acc["psnr_no_den_spec"] += float(psnr(sgram_aug[None], sgram_clean[None]))
        acc["psnr_den_spec"] += float(psnr(sgram_den[None], sgram_clean[None]))
    n = len(queries_augmented)
    return {k: v / n for k, v in acc.items()}


def _masks_sgrams(analyzer: AudfprintPeaks, batch: torch.Tensor):
    """(B, T) -> (masks (B, F, C) bool, sgram (B, F + 1, C)): what
    ``wavfile2peaks`` gives per file, for a batch."""
    return analyzer.peaks_and_spectrograms(analyzer._as_batch(batch))


def compute_peaks_metrics_batched(
    queries_augmented: Sequence[str],
    analyzer_no_den: AudfprintPeaks,
    analyzer_den: AudfprintPeaks,
    cleans_path: Optional[str] = None,
    batch_size: int = 64,
    num_workers: int = 8,
) -> Dict[str, float]:
    """Batched counterpart of :func:`compute_peaks_metrics`: the files are
    decoded by a thread pool, whole batches go through the peaks and the
    frontend on the analyzers' device, and ``batch_peak_metrics`` /
    ``batch_psnr`` score every example at once. Queries are grouped by
    exact (query, clean) lengths, so each example is computed as it is
    alone. Pairs that fail to load print and are skipped."""
    device = _check_devices(analyzer_no_den.device, analyzer_den)
    cleans_path = cleans_path or queries_paths["cleans"]

    def load_pair(qpath):
        try:
            return analyzer_no_den._load(qpath), analyzer_no_den._load(_clean_of(qpath, cleans_path))
        except (OSError, ValueError) as exc:
            print("error with ", qpath, exc)
            return None

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        pairs = [p for p in pool.map(load_pair, queries_augmented) if p is not None]
    groups = collections.defaultdict(list)
    for q, c in pairs:
        groups[(q.shape[0], c.shape[0])].append((q, c))

    sums = {k: torch.zeros((), dtype=torch.float64, device=device) for k in PEAKS_METRICS}
    n = 0
    for items in groups.values():
        for start in range(0, len(items), batch_size):
            chunk = items[start : start + batch_size]
            qb, _ = _stack([q for q, _ in chunk], analyzer_no_den.n_fft, device)
            cb, _ = _stack([c for _, c in chunk], analyzer_no_den.n_fft, device)
            m_clean, sg_clean = _masks_sgrams(analyzer_no_den, cb)
            m_aug, sg_aug = _masks_sgrams(analyzer_no_den, qb)
            m_den, sg_den = _masks_sgrams(analyzer_den, qb)
            pm_aug = batch_peak_metrics(m_aug, m_clean, reduce=False)
            pm_den = batch_peak_metrics(m_den, m_clean, reduce=False)
            for key, per_example in (
                ("precision_no_den", pm_aug["precision"]),
                ("recall_no_den", pm_aug["recall"]),
                ("f1_score_no_den", pm_aug["f1"]),
                ("prec_den", pm_den["precision"]),
                ("rec_den", pm_den["recall"]),
                ("f1_den", pm_den["f1"]),
                ("psnr_no_den_spec", batch_psnr(sg_aug, sg_clean)),
                ("psnr_den_spec", batch_psnr(sg_den, sg_clean)),
            ):
                sums[key] += per_example.sum(dtype=torch.float64)
            n += len(chunk)
    return {k: float(v) / max(n, 1) for k, v in sums.items()}


def _analyzer_pair(denoising_model, spec_denoiser, wave_denoiser, device):
    """(analyzer without a denoiser, analyzer with ``denoising_model``)."""
    no_den = AudfprintPeaks(afp_settings["audfprint"], device=device)
    den = AudfprintPeaks(
        afp_settings["audfprint"],
        denoising=True,
        denoising_model=denoising_model,
        spec_denoiser=spec_denoiser,
        wave_denoiser=wave_denoiser,
        device=device,
    )
    return no_den, den


def _files_of(directory: str):
    return [os.path.join(directory, name) for name in sorted(os.listdir(directory))]


def _write_results(results, filename: str) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, filename), "w") as json_file:
        json.dump(results, json_file, indent=4)


def identification_rate_results(
    denoising_model: Optional[str] = None,
    spec_denoiser=None,
    wave_denoiser=None,
    query_paths: Optional[Dict[str, str]] = None,
    dbpath=None,
    batched: bool = True,
    batch_size: int = 128,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """Identification rate over the condition directories (``query_paths``,
    default the 11 of ``testing/parameters.py``) at 4 shifts: "No
    Denoising", and with a ``denoising_model`` ("unet" with its
    ``spec_denoiser``, "demucs" with its ``wave_denoiser``) also "With
    Denoising" and "Mix Pipeline". ``batched=True`` runs every query file of
    a directory through :func:`compute_accuracy_batched` with one
    :class:`DeviceMatcher` whose device-resident table is reused across the
    conditions; ``batched=False`` is the sequential path of
    :func:`compute_accuracy`. The results are also written to
    ``RESULTS_DIR/accuracy_audfprint_{denoising_model}.json`` ("none"
    without one)."""
    if denoising_model is None and (spec_denoiser is not None or wave_denoiser is not None):
        raise ValueError("a denoiser needs its denoising_model: 'unet' or 'demucs'")
    device = resolve_device(device)
    results = {}
    query_paths = query_paths or queries_paths
    dbpath = dbpath if dbpath is not None else afp_db_paths["audfprint"]
    hash_tab = dbpath if isinstance(dbpath, HashTable) else HashTable(dbpath)
    device_matcher = DeviceMatcher(hash_tab, device=device) if batched else None
    if denoising_model is None:
        analyzers = (AudfprintPeaks(afp_settings["audfprint"], device=device), None)
    else:
        analyzers = _analyzer_pair(denoising_model, spec_denoiser, wave_denoiser, device)
    for a in analyzers:
        if a is not None:
            a.shifts = 4
    for augmentation, query_path in query_paths.items():
        print("augmentation:", augmentation)
        queries = _files_of(query_path)
        if batched:
            results[str(augmentation)] = compute_accuracy_batched(
                queries, hash_tab, *analyzers, batch_size=batch_size, shifts=4,
                device_matcher=device_matcher, device=device,
            )
        else:
            results[str(augmentation)] = compute_accuracy(
                queries, hash_tab, *analyzers, device=device
            )
        print(results[str(augmentation)])
    _write_results(results, f"accuracy_audfprint_{denoising_model or 'none'}.json")
    return results


def peaks_metrics_results(
    denoising_model: str = "unet",
    spec_denoiser=None,
    wave_denoiser=None,
    query_paths: Optional[Dict[str, str]] = None,
    batched: bool = True,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """The eight peak metrics of every condition directory but ``cleans``,
    whose files are the ground truth. ``batched=True`` scores whole batches
    on the device, ``batched=False`` is the sequential per-file path. Also
    written to ``RESULTS_DIR/peaks_metrics_audfprint_{denoising_model}.json``."""
    device = resolve_device(device)
    results = {}
    query_paths = query_paths or queries_paths
    analyzer_no_den, analyzer_den = _analyzer_pair(
        denoising_model, spec_denoiser, wave_denoiser, device
    )
    fn = compute_peaks_metrics_batched if batched else compute_peaks_metrics
    for augmentation, query_path in query_paths.items():
        if augmentation == "cleans":
            continue
        print("augmentation:", augmentation)
        results[str(augmentation)] = fn(
            _files_of(query_path), analyzer_no_den, analyzer_den,
            cleans_path=query_paths.get("cleans"),
        )
        print(results[str(augmentation)])
    _write_results(results, f"peaks_metrics_audfprint_{denoising_model}.json")
    return results


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--action", default="identification_rate")
    parser.add_argument("--model", default="unet")
    args = parser.parse_args()

    if str(args.action) == "index":
        raise NotImplementedError(
            "indexing FMA from its metadata (testing/fma_preprocessing.py) is "
            "not ported; call create_fp_database with a list of audio paths"
        )
    if str(args.action) == "identification_rate":
        identification_rate_results(str(args.model))
    if str(args.action) == "peaks_metrics":
        peaks_metrics_results(str(args.model))


if __name__ == "__main__":
    main()

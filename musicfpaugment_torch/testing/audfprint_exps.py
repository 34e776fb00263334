"""Audfprint evaluation harness (port of the indexing, batched accuracy
and identification-rate parts of musicfpaugment_tpu/testing/audfprint_exps.py).

Inputs are arrays, tensors (kept on their device) or ``.npy``, ``.pkl`` and
``.wav`` paths; a ``names`` list gives the names to index under and the
ground truth to score against when the inputs are not paths.
"""

from __future__ import annotations

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
from musicfpaugment_torch.afp.audfprint.matcher_device import DeviceMatcher
from musicfpaugment_torch.device import DeviceLike, resolve_device
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


def compute_accuracy_batched(
    files: Sequence,
    dbpath,
    analyzer1: AudfprintPeaks,
    analyzer2: Optional[AudfprintPeaks] = None,
    batch_size: int = 128,
    shifts: int = 4,
    device_matcher: Optional[DeviceMatcher] = None,
    names: Optional[Sequence[str]] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Accuracy of the fused device matcher over query waveforms, per
    analyzer, plus the mix rule with two analyzers (the verdict of whichever
    analyzer aligned more hashes). ``names`` are the ground truths when
    ``files`` are not paths; pass a prebuilt ``device_matcher`` to reuse its
    device-resident table."""
    device = resolve_device(device)
    for a in (analyzer1, analyzer2):
        if a is not None and a.device != device:
            raise ValueError(f"analyzer is on {a.device}, not {device}")
    hash_tab = dbpath if isinstance(dbpath, HashTable) else HashTable(dbpath)
    if device_matcher is None:
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
        per_analyzer = [
            device_matcher.match_waveforms(
                batch,
                shifts=shifts,
                density=a.density,
                n_fft=a.n_fft,
                n_hop=a.n_hop,
                f_sd=a.f_sd,
                maxpksperframe=a.maxpksperframe,
                valid_samples=valid_samples,
            )
            for a in analyzers
        ]
        for qi, gt in enumerate(gts):
            n += 1
            preds = []
            for ai, msgs in enumerate(per_analyzer):
                status, name, aligned = msgs[qi]
                pred = _ground_truth(name)
                preds.append((status, pred, aligned))
                if status == "MATCH" and pred == gt:
                    correct[ai] += 1
            if len(preds) == 2:
                best = preds[0] if preds[0][2] >= preds[1][2] else preds[1]
                if best[0] == "MATCH" and best[1] == gt:
                    acc_mix += 1
    out = {"No Denoising": correct[0] / max(n, 1)}
    if analyzer2 is not None:
        out["With Denoising"] = correct[1] / max(n, 1)
        out["Mix Pipeline"] = acc_mix / max(n, 1)
    return out


def identification_rate_results(
    denoising_model: Optional[str] = None,
    spec_denoiser=None,
    wave_denoiser=None,
    query_paths: Optional[Dict[str, str]] = None,
    dbpath=None,
    batch_size: int = 128,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """Identification rate over the condition directories (``query_paths``,
    default the 11 of ``testing/parameters.py``): every query file of a
    directory through ``compute_accuracy_batched`` with 4 shifts, with one
    :class:`DeviceMatcher` whose device-resident table is reused across the
    conditions. The results are also written to
    ``RESULTS_DIR/accuracy_audfprint_none.json``.

    The port has no denoiser yet, so each condition reports "No Denoising"
    only, and asking for one (``denoising_model``, ``spec_denoiser`` or
    ``wave_denoiser``) raises ``NotImplementedError``."""
    if denoising_model is not None or spec_denoiser is not None or wave_denoiser is not None:
        raise NotImplementedError(
            "the denoisers are not ported yet: identification_rate_results "
            "reports the 'No Denoising' arm only"
        )
    device = resolve_device(device)
    results = {}
    query_paths = query_paths or queries_paths
    dbpath = dbpath if dbpath is not None else afp_db_paths["audfprint"]
    hash_tab = dbpath if isinstance(dbpath, HashTable) else HashTable(dbpath)
    device_matcher = DeviceMatcher(hash_tab, device=device)
    analyzer = AudfprintPeaks(afp_settings["audfprint"], device=device)
    for augmentation, query_path in query_paths.items():
        print("augmentation:", augmentation)
        queries = [
            os.path.join(query_path, query) for query in sorted(os.listdir(query_path))
        ]
        results[str(augmentation)] = compute_accuracy_batched(
            queries, hash_tab, analyzer, batch_size=batch_size, shifts=4,
            device_matcher=device_matcher, device=device,
        )
        print(results[str(augmentation)])
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, "accuracy_audfprint_none.json"), "w") as json_file:
        json.dump(results, json_file, indent=4)
    return results

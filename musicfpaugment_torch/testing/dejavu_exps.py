"""Dejavu evaluation harness and CLI (port of
musicfpaugment_tpu/testing/dejavu_exps.py).

Actions: ``identification_rate`` (accuracy over the condition directories:
no-denoise / denoise / mix pipeline, one file at a time through
:class:`FileRecognizer`), ``peaks_metrics`` (peak P/R/F1 and spectrogram
PSNR of augmented and denoised queries against the clean ones), ``index``
(the FMA selection of ``testing/fma_preprocessing.py`` into the configured
database); ``create_fp_database`` indexes any list of files. :func:`compute_accuracy_batched` is the batched
counterpart of :func:`compute_accuracy` through
:class:`DejavuDeviceMatcher`. Unlike the original harness, the peak metrics
are not cut to the first 5 queries of a condition (``max_queries`` bounds
the work instead). Results go to ``RESULTS_DIR/*.json``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures as cf
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from musicfpaugment_torch.afp.dejavu import Dejavu, FileRecognizer
from musicfpaugment_torch.afp.dejavu.dejavu import read as djv_read
from musicfpaugment_torch.afp.dejavu.fingerprint import fingerprint_spectrogram_batch
from musicfpaugment_torch.afp.denoising import WAVEFORM_DENOISERS
from musicfpaugment_torch.device import DeviceLike
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

PEAKS_METRICS = (
    "precision_no_den", "recall_no_den", "f1_score_no_den", "psnr_no_den_spec",
    "prec_den", "rec_den", "f1_den", "psnr_den_spec",
)


def _ground_truth(path) -> str:
    return str(path).split("/")[-1].split(".")[0]


def create_fp_database(
    files: List[str], djv: Optional[Dejavu] = None, device: DeviceLike = None
) -> None:
    """Fingerprint ``files`` one by one into ``djv`` (default: the
    configured dejavu database)."""
    djv = djv or Dejavu(afp_db_paths["dejavu"], afp_settings["dejavu"], "set", device=device)
    djv.fingerprint_directory(files)


def _verdict(result) -> tuple:
    """(song name, aligned count, match) of a recognizer verdict."""
    if not result["match"]:
        return "", 0, False
    top = result["results"][0]
    return top["song_name"].decode("utf-8"), top["nb_matches_with_offset"], True


def _accuracies(tp_no: int, tp_den: int, tp_mix: int, n: int) -> Dict[str, float]:
    return {
        "No Denoising": tp_no / n,
        "With Denoising": tp_den / n,
        "Mix Pipeline": tp_mix / n,
    }


def _score(gt: str, r1, r2) -> tuple:
    """(no-denoise hit, denoise hit, mix hit) of one query: the mix takes the
    verdict with more aligned hashes, the first on a tie."""
    name1, n1, m1 = _verdict(r1)
    name2, n2, m2 = _verdict(r2)
    pred, matched = (name1, m1) if n1 >= n2 else (name2, m2)
    return int(m1 and name1 == gt), int(m2 and name2 == gt), int(matched and pred == gt)


def compute_accuracy(audio_paths: List[str], djv: Dejavu, djv2: Dejavu) -> Dict[str, float]:
    """No-denoise / denoise / mix accuracy, one file at a time through
    :class:`FileRecognizer` (the only path that takes a waveform denoiser's
    arm); the ground truth is each file's stem."""
    recognizer1 = FileRecognizer(djv)
    recognizer2 = FileRecognizer(djv2)
    hits = np.zeros(3, np.int64)
    for path in audio_paths:
        hits += _score(
            _ground_truth(path), recognizer1.recognize_file(path), recognizer2.recognize_file(path)
        )
    return _accuracies(*hits.tolist(), len(audio_paths))


def compute_accuracy_batched(
    audio_paths: List[str],
    matcher_no_den,
    matcher_den,
    batch_size: int = 64,
) -> Dict[str, float]:
    """Batched :func:`compute_accuracy` through two
    :class:`~musicfpaugment_torch.afp.dejavu.DejavuDeviceMatcher` (the
    second with its spectrogram denoiser): whole batches go waveform ->
    verdict on the matchers' device. Queries are loaded by :func:`read`
    (wav/pkl/npy, mono downmix, int16 scaling) and must share one length
    within a batch."""
    sr = matcher_no_den.settings["samplerate"]
    hits = np.zeros(3, np.int64)
    for start in range(0, len(audio_paths), batch_size):
        chunk = audio_paths[start : start + batch_size]
        loaded = [djv_read(p, sample_rate=sr)[0][0] for p in chunk]
        if len({w.shape[0] for w in loaded}) != 1:
            raise ValueError(
                "compute_accuracy_batched requires uniform query lengths "
                "within a chunk; use compute_accuracy for mixed lengths"
            )
        wavs = np.stack(loaded)
        v1 = matcher_no_den.recognize_waveforms(wavs)
        v2 = matcher_den.recognize_waveforms(wavs)
        for path, r1, r2 in zip(chunk, v1, v2):
            hits += _score(_ground_truth(path), r1, r2)
    return _accuracies(*hits.tolist(), max(len(audio_paths), 1))


def _clean_of(query_path, cleans_path: str) -> str:
    return os.path.join(cleans_path, str(query_path).split("/")[-1])


def compute_peaks_metrics(
    queries_augmented: List[str],
    djv_no_den: Dejavu,
    djv_den: Dejavu,
    cleans_path: Optional[str] = None,
    max_queries: Optional[int] = None,
) -> Dict[str, float]:
    """Peak precision / recall / F1 and spectrogram PSNR of the augmented
    queries and of the same queries denoised, each against the clean query
    of the same file name under ``cleans_path``, one file at a time; means
    over the queries."""
    cleans_path = cleans_path or queries_paths["cleans"]
    if max_queries is not None:
        queries_augmented = queries_augmented[:max_queries]
    precision, recall, f1_score = Precision(), Recall(), F1score()
    acc = {k: 0.0 for k in PEAKS_METRICS}
    for qpath in queries_augmented:
        m_clean, sgram_clean = djv_no_den.generate_fingerprints(
            _clean_of(qpath, cleans_path), get_masks=True
        )
        m_aug, sgram_aug = djv_no_den.generate_fingerprints(qpath, get_masks=True)
        m_den, sgram_den = djv_den.generate_fingerprints(qpath, get_masks=True)
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


def _masks_sgrams(djv: Dejavu, batch: np.ndarray):
    """(B, T) raw waveforms -> (peak masks, PSD spectrograms) on the
    engine's device: ``generate_fingerprints(get_masks=True)`` for a batch,
    a waveform denoiser applied to the raw audio as :func:`read` applies it."""
    w = torch.as_tensor(batch, dtype=torch.float32, device=djv.device)
    if djv.denoising and djv.denoising_model in WAVEFORM_DENOISERS:
        w = djv.wave_denoiser(w)
    st = djv.settings
    _, mask, specgram = fingerprint_spectrogram_batch(
        w * 32767.0, st["samplerate"], st["n_fft"], st["n_hop"], st["amp_min"],
        denoiser=djv._spec_hook(),
    )
    return mask, specgram


def compute_peaks_metrics_batched(
    queries_augmented: List[str],
    djv_no_den: Dejavu,
    djv_den: Dejavu,
    cleans_path: Optional[str] = None,
    max_queries: Optional[int] = None,
    batch_size: int = 64,
    num_workers: int = 8,
) -> Dict[str, float]:
    """Batched :func:`compute_peaks_metrics`: files decoded by a thread
    pool, whole batches through the spectrogram and peaks on the engines'
    device, and ``batch_peak_metrics`` / ``batch_psnr`` scoring every
    example at once. Queries are grouped by exact (query, clean) lengths,
    so each example is computed as it is alone. A waveform denoiser denoises
    the raw audio of a batch, where :func:`read` denoises each file (per file it
    denoises before any resampling, here after loading: the same whenever
    the queries are at the target rate). Pairs that fail to load print and
    are skipped."""
    cleans_path = cleans_path or queries_paths["cleans"]
    if max_queries is not None:
        queries_augmented = queries_augmented[:max_queries]
    sr = djv_no_den.settings["samplerate"]

    def load_pair(qpath):
        try:
            q = djv_read(qpath, sample_rate=sr, int16_scale=False)[0][0]
            c = djv_read(_clean_of(qpath, cleans_path), sample_rate=sr, int16_scale=False)[0][0]
            return q, c
        except (OSError, ValueError) as exc:
            print("error with ", qpath, exc)
            return None

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        pairs = [p for p in pool.map(load_pair, queries_augmented) if p is not None]
    groups = collections.defaultdict(list)
    for q, c in pairs:
        groups[(q.shape[0], c.shape[0])].append((q, c))

    sums = {
        k: torch.zeros((), dtype=torch.float64, device=djv_no_den.device) for k in PEAKS_METRICS
    }
    n = 0
    for items in groups.values():
        for start in range(0, len(items), batch_size):
            chunk = items[start : start + batch_size]
            qb = np.stack([q for q, _ in chunk])
            cb = np.stack([c for _, c in chunk])
            m_clean, sg_clean = _masks_sgrams(djv_no_den, cb)
            m_aug, sg_aug = _masks_sgrams(djv_no_den, qb)
            m_den, sg_den = _masks_sgrams(djv_den, qb)
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


def _engines(denoising_model, spec_denoiser, wave_denoiser, db, device):
    """(Dejavu without a denoiser, Dejavu with ``denoising_model``) over the
    configured database, or ``db``."""
    djv = Dejavu(afp_db_paths["dejavu"], afp_settings["dejavu"], "set", db=db, device=device)
    djv_den = Dejavu(
        afp_db_paths["dejavu"],
        afp_settings["dejavu"],
        "set",
        denoising=True,
        denoising_model=denoising_model,
        spec_denoiser=spec_denoiser,
        wave_denoiser=wave_denoiser,
        db=db,
        device=device,
    )
    return djv, djv_den


def _files_of(directory: str) -> List[str]:
    return [os.path.join(directory, q) for q in sorted(os.listdir(directory))]


def _write_results(results, filename: str) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    with open(os.path.join(RESULTS_DIR, filename), "w") as json_file:
        json.dump(results, json_file, indent=4)


def identification_rate_results(
    denoising_model: str = "unet",
    spec_denoiser=None,
    wave_denoiser=None,
    query_paths: Optional[Dict[str, str]] = None,
    db=None,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """:func:`compute_accuracy` over every condition directory of
    ``query_paths`` (default the 11 of ``testing/parameters.py``), written
    to ``RESULTS_DIR/accuracy_dejavu_{denoising_model}.json``."""
    results = {}
    query_paths = query_paths or queries_paths
    djv, djv_den = _engines(denoising_model, spec_denoiser, wave_denoiser, db, device)
    for augmentation, query_path in query_paths.items():
        print("augmentation:", augmentation)
        results[str(augmentation)] = compute_accuracy(_files_of(query_path), djv, djv_den)
        print(results[str(augmentation)])
    _write_results(results, f"accuracy_dejavu_{denoising_model}.json")
    return results


def peaks_metrics_results(
    denoising_model: str = "unet",
    spec_denoiser=None,
    wave_denoiser=None,
    query_paths: Optional[Dict[str, str]] = None,
    db=None,
    max_queries: Optional[int] = None,
    batched: bool = True,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """The eight peak metrics of every condition directory but ``cleans``,
    whose files are the ground truth: whole batches on the device with
    ``batched=True``, one file at a time with ``batched=False``. Written to
    ``RESULTS_DIR/peaks_metrics_dejavu_{denoising_model}.json``."""
    results = {}
    query_paths = query_paths or queries_paths
    djv, djv_den = _engines(denoising_model, spec_denoiser, wave_denoiser, db, device)
    fn = compute_peaks_metrics_batched if batched else compute_peaks_metrics
    for augmentation, query_path in query_paths.items():
        if augmentation == "cleans":
            continue
        print("augmentation:", augmentation)
        results[str(augmentation)] = fn(
            _files_of(query_path), djv, djv_den,
            cleans_path=query_paths.get("cleans"), max_queries=max_queries,
        )
        print(results[str(augmentation)])
    _write_results(results, f"peaks_metrics_dejavu_{denoising_model}.json")
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--action", default="identification_rate")
    parser.add_argument("--model", default="unet")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)

    if str(args.action) == "index":
        # the FMA selection's paths (testing/fma_preprocessing.py's output)
        from musicfpaugment_torch.testing.fma_preprocessing import preprocessed_table

        create_fp_database(preprocessed_table()["file_paths"], device=args.device)
    if str(args.action) == "identification_rate":
        identification_rate_results(str(args.model), device=args.device)
    if str(args.action) == "peaks_metrics":
        peaks_metrics_results(str(args.model), device=args.device)


if __name__ == "__main__":
    main()

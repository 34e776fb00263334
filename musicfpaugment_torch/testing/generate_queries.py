"""Query generation CLI (port of
musicfpaugment_tpu/testing/generate_queries.py).

``--queries=cleans``: random (seed 42) 8 s crop of each selected FMA track at
8 kHz mono -> one pickle per file. ``--queries=augmented``: each of the 10
frozen-seed(42) AugmentFP conditions applied to every clean query, in
batches on the device; every example's randomness is a function of the seed
and its index in the sorted clean set, so the query set does not depend on
the batch size or on the device.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from musicfpaugment_torch.augment import AugmentFP
from musicfpaugment_torch.data.audio_io import read_wav, resample
from musicfpaugment_torch.device import DeviceLike
from musicfpaugment_torch.testing.parameters import (
    WAVEFORM_SAMPLING_RATE,
    queries_paths,
    test_pipelines_parameters,
)

NOISE_SPLIT_PATH = os.environ.get(
    "MFPA_NOISE_SPLIT", "/workspace/src/training/splits/train.json"
)


def generate_clean_queries(
    paths: List[str],
    save_path: str,
    sr: int = WAVEFORM_SAMPLING_RATE,
    duration: int = 8,
    burn_in: int = 0,
    save: bool = False,
) -> None:
    """Seed-42 random crops of ``duration`` seconds, one pickle per file."""
    random.seed(42)
    os.makedirs(save_path, exist_ok=True)
    for path in paths:
        if not os.path.isfile(path):
            print(path + " A file is missing")
            continue
        data, origin_sr = read_wav(path)
        waveform = data.mean(axis=0) if data.shape[0] > 1 else data[0]
        waveform = resample(waveform, origin_sr, sr)
        try:
            nb_samples_segment = sr * duration
            start = random.randrange(
                burn_in, waveform.shape[0] - nb_samples_segment - burn_in
            )
            waveform = waveform[start : start + nb_samples_segment]
            if save:
                name = os.path.basename(path).split(".")[0] + ".pkl"
                with open(os.path.join(save_path, name), "wb") as handle:
                    pickle.dump(np.asarray(waveform), handle)
        except Exception:
            print(path + " is " + str(waveform.shape[0]) + "long")


def generate_augmented_queries(
    save_path: str,
    parameters: Dict[str, float],
    save: bool = False,
    augmenter: Optional[AugmentFP] = None,
    cleans_path: Optional[str] = None,
    batch_size: int = 256,
    device: DeviceLike = None,
) -> None:
    """Every clean query under ``cleans_path`` through the frozen-seed(42)
    chain, in batches; one pickle per query under ``save_path``. Without an
    ``augmenter`` one is built on ``device`` (``None`` = CUDA) from the noise
    split file and ``parameters``."""
    if augmenter is None:
        with open(NOISE_SPLIT_PATH, "r") as f:
            noise_paths = json.load(f)
        augmenter = AugmentFP(
            noise_paths, WAVEFORM_SAMPLING_RATE, parameters=parameters, device=device
        )
    augmenter.freeze_parameters(42)
    os.makedirs(save_path, exist_ok=True)
    cleans_path = cleans_path or queries_paths["cleans"]
    clean_queries = sorted(os.listdir(cleans_path))

    for i in range(0, len(clean_queries), batch_size):
        names = clean_queries[i : i + batch_size]
        batch, kept, kept_idx = [], [], []
        for j, query in enumerate(names):
            try:
                with open(os.path.join(cleans_path, str(query)), "rb") as f:
                    clean_audio = np.asarray(pickle.load(f), np.float32).reshape(-1)
                batch.append(clean_audio)
                kept.append(query)
                kept_idx.append(i + j)
            except Exception:
                print("error with : ", query)
        if not batch:
            continue
        wavs = np.stack(batch)[:, None, :]  # (B, 1, T)
        # per-example draws from the *global* query index
        augmented = augmenter.batch_augment_indexed(wavs, kept_idx)[:, 0, :].cpu().numpy()
        if save:
            for query, aug in zip(kept, augmented):
                with open(os.path.join(save_path, str(query)), "wb") as handle:
                    pickle.dump(np.asarray(aug), handle)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--queries", default="augmented")
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)

    if str(args.queries) == "cleans":
        from musicfpaugment_torch.testing.fma_preprocessing import TestSet, preprocessed_table

        testset = TestSet(preprocessed_table())
        testset.remove_short_tracks()
        selected_queries = testset.sample_queries()
        selected_queries = testset.remove_exceptions(selected_queries)
        generate_clean_queries(selected_queries, queries_paths["cleans"], save=args.save)

    if str(args.queries) == "augmented":
        for pipeline_type, params in test_pipelines_parameters.items():
            print(str(pipeline_type))
            generate_augmented_queries(
                queries_paths[str(pipeline_type)], params, save=args.save,
                device=args.device,
            )


if __name__ == "__main__":
    main()

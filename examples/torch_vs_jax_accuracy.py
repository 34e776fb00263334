"""Identification accuracy of both packages on one synthetic corpus, on the CPU.

    JAX_PLATFORMS=cpu python examples/torch_vs_jax_accuracy.py [--tracks 1000] [--queries 512]

Tests whether the port's accuracy under ``default_parameters`` on its
synthetic corpus (0.948 over 10,000 tracks on the card) against the JAX
package's 0.63 on 106k FMA tracks comes from the corpus or from the code.
The port's ``data/synthetic.py`` makes the tracks (20-30 s at 8 kHz, from a
seed); each package indexes the same numpy arrays into its own full-size
2^20 x 100 table with its own code, degrades the same 8 s crops of indexed
tracks with its own ``AugmentFP`` under ``default_parameters`` (frozen seed
42, banks from ``dcase_shaped_banks()`` with the same seed: the same arrays
in both) and matches them at 4 shifts. The two packages draw the chain's
parameters from different generators, so the degraded queries differ: the
accuracies agree statistically or not at all. Prints one JSON line with
both accuracies, clean and degraded, and their 95% Wilson intervals.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.augment import AugmentFP, dcase_shaped_banks
from musicfpaugment_torch.data.synthetic import synth_tracks_device
from musicfpaugment_torch.testing.audfprint_exps import compute_accuracy_batched, create_fp_database
from musicfpaugment_torch.testing.parameters import afp_settings, test_pipelines_parameters

SR = 8000
TRACK_SECONDS = (20, 30)
QUERY_SECONDS = 8
CORPUS_SEED = 2023
AUGMENT_SEED = 42
BATCH = 128


def wilson(k: int, n: int, z: float = 1.959963984540054) -> list:
    """95% Wilson score interval of k successes in n trials."""
    p = k / n
    centre = (p + z * z / (2 * n)) / (1 + z * z / n)
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / (1 + z * z / n)
    return [centre - half, centre + half]


def make_corpus(n_tracks: int, n_queries: int):
    r = np.random.default_rng(CORPUS_SEED)
    lengths = r.integers(TRACK_SECONDS[0] * SR, TRACK_SECONDS[1] * SR + 1, n_tracks)
    tracks = []
    for s in range(0, n_tracks, 64):
        idx = list(range(s, min(s + 64, n_tracks)))
        block = synth_tracks_device(CORPUS_SEED, idx, TRACK_SECONDS[1] * SR, SR, device="cpu").numpy()
        tracks += [block[j, : int(lengths[i])].copy() for j, i in enumerate(idx)]
    q_ids = r.integers(0, n_tracks, n_queries)
    q_offs = [int(r.integers(0, int(lengths[t]) - QUERY_SECONDS * SR)) for t in q_ids]
    clean = np.stack([tracks[t][o : o + QUERY_SECONDS * SR] for t, o in zip(q_ids, q_offs)])
    return tracks, q_ids, clean


def degrade(fp, clean: np.ndarray, to_numpy) -> np.ndarray:
    fp.freeze_parameters(AUGMENT_SEED)
    return np.concatenate([
        to_numpy(fp.batch_augment_indexed(clean[s : s + BATCH], np.arange(s, min(s + BATCH, len(clean)))))
        for s in range(0, len(clean), BATCH)
    ])


def port_run(tracks, q_ids, clean, params) -> dict:
    names = [f"track{i:05d}" for i in range(len(tracks))]
    analyzer = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    ht = create_fp_database([torch.from_numpy(t) for t in tracks], None, analyzer=analyzer,
                            hash_tab=HashTable(), names=names, device="cpu")
    dm = DeviceMatcher(ht, device="cpu")
    noise_bank, ir_bank = dcase_shaped_banks(device="cpu")
    fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device="cpu")
    degraded = degrade(fp, clean, lambda x: x.numpy())
    q_names = [names[int(t)] for t in q_ids]
    out = {}
    for label, qs in (("cleans", clean), ("default_parameters", degraded)):
        acc = compute_accuracy_batched(list(qs), ht, analyzer, batch_size=BATCH, shifts=4,
                                       device_matcher=dm, names=q_names, device="cpu")
        out[label] = acc["No Denoising"]
    return out


def jax_run(tracks, q_ids, clean, params, workdir) -> dict:
    from musicfpaugment_tpu.afp.audfprint import AudfprintPeaks as JPeaks
    from musicfpaugment_tpu.afp.audfprint import DeviceMatcher as JMatcher
    from musicfpaugment_tpu.afp.audfprint import HashTable as JHashTable
    from musicfpaugment_tpu.augment.pipeline import AugmentFP as JAugmentFP
    from musicfpaugment_tpu.augment.pipeline import dcase_shaped_banks as j_banks
    from musicfpaugment_tpu.testing.audfprint_exps import compute_accuracy_batched as j_accuracy
    from musicfpaugment_tpu.testing.audfprint_exps import create_fp_database as j_database
    from musicfpaugment_tpu.testing.parameters import afp_settings as j_settings

    # the JAX package names tracks and queries by their file names
    files = []
    for i, t in enumerate(tracks):
        files.append(os.path.join(workdir, "tracks", f"track{i:05d}.npy"))
        np.save(files[-1], t)
    analyzer = JPeaks(j_settings["audfprint"])
    ht = j_database(files, None, analyzer=analyzer, hash_tab=JHashTable())
    dm = JMatcher(ht)
    noise_bank, ir_bank = j_banks()
    fp = JAugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank)
    degraded = degrade(fp, clean, np.asarray)
    out = {}
    for label, qs in (("cleans", clean), ("default_parameters", degraded)):
        q_files = []
        for i, (t, q) in enumerate(zip(q_ids, qs)):
            d = os.path.join(workdir, label, f"{i:04d}")
            os.makedirs(d)
            q_files.append(os.path.join(d, f"track{int(t):05d}.npy"))
            np.save(q_files[-1], q)
        acc = j_accuracy(q_files, ht, analyzer, batch_size=BATCH, shifts=4, device_matcher=dm)
        out[label] = acc["No Denoising"]
    return out


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tracks", type=int, default=1000)
    parser.add_argument("--queries", type=int, default=512)
    args = parser.parse_args()
    params = test_pipelines_parameters["default_parameters"]
    t0 = time.perf_counter()
    tracks, q_ids, clean = make_corpus(args.tracks, args.queries)
    line = {"tracks": args.tracks, "queries": args.queries, "device": "cpu",
            "corpus_seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    line["port"] = port_run(tracks, q_ids, clean, params)
    line["port_seconds"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as workdir:
        os.makedirs(os.path.join(workdir, "tracks"))
        t0 = time.perf_counter()
        line["jax"] = jax_run(tracks, q_ids, clean, params, workdir)
        line["jax_seconds"] = time.perf_counter() - t0
    for pkg in ("port", "jax"):
        line[pkg + "_interval_95"] = {
            k: wilson(round(v * args.queries), args.queries) for k, v in line[pkg].items()}
    a, b = line["port_interval_95"]["default_parameters"], line["jax_interval_95"]["default_parameters"]
    line["intervals_overlap"] = a[0] <= b[1] and b[0] <= a[1]
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()

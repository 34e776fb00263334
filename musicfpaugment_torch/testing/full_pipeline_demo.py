"""End-to-end demo of the paper's pipeline at a small scale (port of
examples/full_pipeline_demo.py), on synthetic data:

  synthetic corpus -> noise and impulse-response banks -> denoiser training
  (UNet, or Demucs with ``--model demucs``; ``AugmentFP`` inside each step
  on the card) -> clean and augmented queries (frozen seed 42) -> audfprint
  index -> identification rate (No Denoising / With Denoising / Mix
  Pipeline) and peak P/R/F1 and PSNR per condition -> a results JSON.

Run:  python -m musicfpaugment_torch.testing.full_pipeline_demo [--tracks 48] [--epochs 8]
Quick pass: ``--tracks 16 --epochs 2 --queries 16``. Writes ``--out``
(default ``<tmp>/full_pipeline_demo``): the queries and
``results.json`` (``results_demucs.json`` for Demucs). Runs on CUDA and
raises without it unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, HashTable
from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
from musicfpaugment_torch.convert import demucs_denoiser, unet_denoiser
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.device import resolve_device
from musicfpaugment_torch.models import Demucs, UNet
from musicfpaugment_torch.testing.audfprint_exps import (
    compute_accuracy_batched,
    compute_peaks_metrics,
)
from musicfpaugment_torch.testing.generate_queries import generate_augmented_queries
from musicfpaugment_torch.testing.parameters import afp_settings, test_pipelines_parameters
from musicfpaugment_torch.train.trainer import Trainer

SR = 8000


def make_corpus(n_tracks: int, seconds: int = 12, seed: int = 7) -> np.ndarray:
    gen = synthetic_clean_batches(1, seconds * SR, SR, seed=seed)
    return np.stack([next(gen)[0] for _ in range(n_tracks)])


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracks", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--queries", type=int, default=48)
    ap.add_argument("--conditions", nargs="*", default=["bn_0", "full_hard", "reverb"])
    ap.add_argument("--model", choices=["unet", "demucs"], default="unet")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "full_pipeline_demo"))
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    t_all = time.time()

    # 1. corpus and banks
    tracks = make_corpus(args.tracks)
    noise_bank, ir_bank = synthetic_banks(
        sample_rate=SR, noise_row_length=8 * SR, num_noise=24, num_irs=12, device=dev
    )
    augmenter = AugmentFP(noise_bank, SR, impulse_response_dir=ir_bank, device=dev)

    # 2. the denoiser at its published width, augmentation inside each step
    print(f"== training {args.model} ==", flush=True)
    t0 = time.time()
    if args.model == "unet":
        model, input_type, lr = UNet(1, 1, rate=0.05), "spec", 1e-3
    else:
        model, input_type, lr = Demucs(), "audio", 5e-4
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = Trainer(
            model=model,
            train_iter=synthetic_clean_batches(args.batch, 3 * SR, SR, seed=11),
            train_steps=args.steps,
            val_iter=synthetic_clean_batches(args.batch, 3 * SR, SR, seed=12),
            val_steps=4,
            learning_rate=lr,
            nb_epochs=args.epochs + 1,
            checkpoint=ckpt,
            input_type=input_type,
            augmenter=augmenter,
            example_batch=next(synthetic_clean_batches(args.batch, 3 * SR, SR)),
            device=dev,
        )
        trainer.start_epoch()
        trainer.training_loop()
    train_time = time.time() - t0
    losses = [float(h["val"]["loss"]) for h in trainer.history]
    print(f"train {train_time:.0f}s; val loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if args.model == "unet":
        denoiser_kwargs = dict(denoising=True, denoising_model="unet",
                               spec_denoiser=unet_denoiser(trainer.model))
    else:
        denoiser_kwargs = dict(denoising=True, denoising_model="demucs",
                               wave_denoiser=demucs_denoiser(trainer.model))

    # 3. queries: one per distinct track, the file stem the track's name
    print("== generating queries ==", flush=True)
    cleans_dir = os.path.join(args.out, "queries", "cleans")
    shutil.rmtree(os.path.join(args.out, "queries"), ignore_errors=True)
    os.makedirs(cleans_dir, exist_ok=True)
    rng = np.random.default_rng(42)
    q_ids = rng.permutation(args.tracks)[: min(args.queries, args.tracks)]
    for tid in q_ids:
        start = int(rng.integers(0, tracks.shape[1] - 8 * SR))
        with open(os.path.join(cleans_dir, f"{tid:04d}.pkl"), "wb") as f:
            pickle.dump(tracks[tid, start : start + 8 * SR].astype(np.float32), f)
    query_paths = {"cleans": cleans_dir}
    for cond in args.conditions:
        params_c = test_pipelines_parameters[cond]
        cond_dir = os.path.join(args.out, "queries", cond)
        cond_augmenter = AugmentFP(
            noise_bank, SR, parameters=params_c, impulse_response_dir=ir_bank, device=dev
        )
        generate_augmented_queries(cond_dir, params_c, save=True, augmenter=cond_augmenter,
                                   cleans_path=cleans_dir, device=dev)
        query_paths[cond] = cond_dir

    # 4. index
    print("== indexing ==", flush=True)
    ht = HashTable()
    AudfprintPeaks(afp_settings["audfprint"], device=dev).ingest_batch(
        ht, [f"{i:04d}" for i in range(args.tracks)], tracks
    )

    # 5. evaluation
    print("== evaluating ==", flush=True)
    a_plain = AudfprintPeaks(afp_settings["audfprint"], device=dev)
    a_den = AudfprintPeaks(afp_settings["audfprint"], device=dev, **denoiser_kwargs)
    results = {"model": args.model, "train_val_loss": losses, "train_seconds": train_time}
    for cond, path in query_paths.items():
        files = [os.path.join(path, q) for q in sorted(os.listdir(path))]
        acc = compute_accuracy_batched(files, ht, a_plain, a_den, shifts=4, device=dev)
        results[cond] = {"accuracy": acc}
        print(cond, acc, flush=True)
        if cond != "cleans":
            pm = compute_peaks_metrics(files[:12], a_plain, a_den, cleans_path=cleans_dir)
            results[cond]["peaks"] = pm
            print(cond, "f1 aug/den:", round(pm["f1_score_no_den"], 3), round(pm["f1_den"], 3),
                  flush=True)

    results["total_seconds"] = time.time() - t_all
    name = "results.json" if args.model == "unet" else f"results_{args.model}.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(f"== done in {results['total_seconds']:.0f}s -> {args.out}/{name} ==")
    return results


if __name__ == "__main__":
    main()

"""The UNet training step with a noise bank of realistic size (port of
examples/big_bank_train.py).

The trainer degrades each clean batch on the device from noise and impulse
response banks that live there as tensors, passed to the chain as data.
With a DCASE-sized bank (hundreds of MB) the step must take what the toy
bank's step takes: the bank is neither copied nor uploaded again per step.
This runs the same ``base=8`` UNet step (batch 32 x 3 s by default) with a
``--mb`` noise bank built by ``augment.build_noise_bank`` and with the
32-row toy bank of ``synthetic_banks``, and reports for each the median
step ms, the peak memory, the bytes allocated per step and the bank's
bytes; the bank's storage must be the same tensor before and after the
steps.

Run on the card:  python -m musicfpaugment_torch.train.big_bank_train [--mb 256]
On the CPU:       python -m musicfpaugment_torch.train.big_bank_train --device cpu --mb 4 --steps 1
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from musicfpaugment_torch import augment
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.device import resolve_device
from musicfpaugment_torch.models import UNet
from musicfpaugment_torch.train.trainer import Trainer

SR = 8000
SECONDS = 3
TOY_ROWS = 32


def big_noise_bank(mb: int, num_samples: int, device) -> augment.NoiseBank:
    """A ``mb`` MB bank of (rows, num_samples) scaled white noise rows."""
    rows = max(1, mb * 2**20 // (4 * num_samples))
    data = np.random.default_rng(0).standard_normal((rows, num_samples)).astype(np.float32) * 0.1
    return augment.build_noise_bank(data, SR, row_length=num_samples, device=device)


def bank_bytes(noise_bank: augment.NoiseBank) -> int:
    return sum(t.numel() * t.element_size()
               for t in (noise_bank.clips, noise_bank.scene_starts, noise_bank.scene_counts))


def time_steps(noise_bank, ir_bank, clean: np.ndarray, steps: int, device) -> dict:
    """One warm-up step, then ``steps`` timed steps of a fresh trainer on
    this bank: median ms, peak and per-step allocated memory (CUDA only),
    whether the bank's storage stayed where it was."""
    augmenter = augment.AugmentFP(noise_bank, SR, impulse_response_dir=ir_bank, device=device)
    ptr = noise_bank.clips.data_ptr()
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(
            UNet(1, 1, rate=0.05, base=8), iter([clean] * (steps + 1)), steps + 1,
            iter([clean]), 1, 1e-3, 1, tmp, input_type="spec", augmenter=augmenter,
            example_batch=clean, device=device,
        )
        trainer.train_step(*trainer._get_batch(trainer.train_iter))
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            before = torch.cuda.memory_stats(device)["allocated_bytes.all.allocated"]
        times, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            terms = trainer.train_step(*trainer._get_batch(trainer.train_iter))
            losses.append(float(terms["loss"]))  # the read waits for the step
            times.append((time.perf_counter() - t0) * 1e3)
        line = {
            "bank_mb": round(bank_bytes(noise_bank) / 2**20, 2),
            "bank_rows": int(noise_bank.num_clips),
            "step_ms": statistics.median(times),
            "loss": losses[-1],
            "bank_resident": trainer.augmenter.noise_bank.clips.data_ptr() == ptr,
            "peak_mb": None,
            "allocated_mb_per_step": None,
        }
        if cuda:
            after = torch.cuda.memory_stats(device)["allocated_bytes.all.allocated"]
            line["peak_mb"] = round(torch.cuda.max_memory_allocated(device) / 2**20, 1)
            line["allocated_mb_per_step"] = round((after - before) / steps / 2**20, 2)
    return line


def run(mb: int = 256, batch: int = 32, steps: int = 8, device=None) -> dict:
    """The big bank's step against the toy bank's; raises if the big bank
    did not stay resident or a loss is not finite."""
    dev = resolve_device(device)
    n = SECONDS * SR
    clean = next(synthetic_clean_batches(batch, n, SR))
    toy_noise, ir_bank = augment.synthetic_banks(
        sample_rate=SR, num_noise=TOY_ROWS, noise_row_length=n, device=dev)
    big = time_steps(big_noise_bank(mb, n, dev), ir_bank, clean, steps, dev)
    toy = time_steps(toy_noise, ir_bank, clean, steps, dev)
    out = {"batch": batch, "clip_seconds": SECONDS, "steps": steps, "big": big, "toy": toy}
    for name, line in (("big", big), ("toy", toy)):
        if not line["bank_resident"] or not np.isfinite(line["loss"]):
            raise RuntimeError(f"{name} bank: {line}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mb", type=int, default=256, help="noise bank size, MB")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=8, help="timed steps after one warm-up step")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    print(json.dumps(run(args.mb, args.batch, args.steps, args.device)), flush=True)


if __name__ == "__main__":
    main()

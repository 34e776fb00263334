"""Training CLI (port of musicfpaugment_tpu/train/train.py):

    python -m musicfpaugment_torch.train.train --model unet|demucs [--device cuda]

Data sources resolve in order: MTG-Jamendo and DCASE where they are mounted
(the reference's datasets), otherwise synthetic clean batches and synthetic
noise/IR banks, so that the command runs anywhere. Augmentation runs on the
device inside the training step (the loaders ship clean batches). The
device is ``--device`` (CUDA by default); without CUDA the command raises
unless it is given ``--device cpu``. ``--multihost`` trains data-parallel,
one process per device, as ``torchrun --nproc-per-node N -m
musicfpaugment_torch.train.train --multihost`` starts them.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from musicfpaugment_torch.augment.pipeline import AugmentFP, synthetic_banks
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.device import DeviceLike, resolve_device
from musicfpaugment_torch.models import Demucs, UNet
from musicfpaugment_torch.train import parameters as P
from musicfpaugment_torch.train.trainer import EarlyStopping, ReduceLROnPlateau, Trainer
from musicfpaugment_torch.train.utils import fix_random_seeds

CHECKPOINT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints")


def build_augmenter(sample_rate: int, device: DeviceLike = None) -> AugmentFP:
    """DCASE noise and MIT IRs when available; synthetic banks otherwise."""
    try:
        from musicfpaugment_torch.augment.constants import IMPULSE_RESPONSE_DIR
        from musicfpaugment_torch.data.dcase import load_noise_split

        background_paths = load_noise_split("train")
        if not os.path.isdir(IMPULSE_RESPONSE_DIR):
            raise FileNotFoundError(IMPULSE_RESPONSE_DIR)
        return AugmentFP(background_paths, sample_rate, device=device)
    except (ImportError, FileNotFoundError, OSError):
        print("INFO: datasets not mounted — using synthetic noise/IR banks")
        noise_bank, ir_bank = synthetic_banks(
            sample_rate=sample_rate,
            noise_row_length=P.DURATION * sample_rate,
            device=device,
        )
        return AugmentFP(noise_bank, sample_rate, impulse_response_dir=ir_bank, device=device)


def build_data(batch_size: int, sample_rate: int, duration: int):
    """Jamendo loaders when mounted; synthetic batches otherwise."""
    try:
        from musicfpaugment_torch.data.jamendo import get_data_loaders

        return get_data_loaders(batch_size=batch_size, val_steps=P.VAL_STEPS, run_val=P.RUN_VAL)
    except (ImportError, FileNotFoundError, OSError):
        print("INFO: MTG-Jamendo not mounted — using synthetic clean batches")
        n = duration * sample_rate
        return (
            synthetic_clean_batches(batch_size, n, sample_rate, seed=59),
            synthetic_clean_batches(batch_size, n, sample_rate, seed=4),
        )


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="unet", choices=["unet", "demucs"])
    parser.add_argument("--epochs", type=int, default=P.NB_EPOCHS)
    parser.add_argument("--batch-size", type=int, default=P.BATCH_SIZE)
    parser.add_argument("--train-steps", type=int, default=P.TRAIN_STEPS)
    parser.add_argument("--val-steps", type=int, default=P.VAL_STEPS)
    parser.add_argument("--save", action="store_true")
    parser.add_argument("--monitoring", action="store_true",
                        help="TensorBoard scalars every epoch and validation triplets every "
                        "10 epochs under <checkpoint>/tb (needs the tensorboard package; "
                        "without it the scalars stay in the trainer's history)")
    parser.add_argument("--base", type=int, default=64,
                        help="UNet width scale (64 = reference plan)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (float32 parameters and Adam state)")
    parser.add_argument(
        "--multihost", action="store_true",
        help="data-parallel training, one process per device: join the "
        "torch.distributed group named by MASTER_ADDR, MASTER_PORT, WORLD_SIZE "
        "and RANK (as torchrun sets them; NCCL on CUDA, gloo on the CPU), with "
        "the same arguments in every process; the batch size is the global one",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    if args.multihost:
        from musicfpaugment_torch.parallel.mesh import init_multihost

        rank = init_multihost(device=device)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        print(f"multihost: process {rank} joined the group")

    fix_random_seeds()
    dtype = torch.bfloat16 if args.bf16 else None
    if args.model == "unet":
        learning_rate = 1e-3
        model = UNet(1, 1, rate=0.05, base=args.base, dtype=dtype)
        input_type = "spec"
    else:
        learning_rate = 5e-4
        # the Trainer draws Flax's weights and rescales them (the JAX trainer's init)
        model = Demucs(dtype=dtype)
        input_type = "audio"
    ckpt_name = f"{args.model}_lr_{learning_rate}_BS_{args.batch_size}"
    ckpt_path = os.path.join(CHECKPOINT_ROOT, ckpt_name)

    sr = P.WAVEFORM_SAMPLING_RATE
    train_iter, val_iter = build_data(args.batch_size, sr, P.DURATION)
    augmenter = build_augmenter(sr, device)
    example = next(train_iter)
    if isinstance(example, tuple):
        example = example[0]

    trainer = Trainer(
        model=model,
        train_iter=train_iter,
        train_steps=args.train_steps,
        val_iter=val_iter,
        val_steps=args.val_steps,
        learning_rate=learning_rate,
        nb_epochs=args.epochs,
        checkpoint=ckpt_path,
        input_type=input_type,
        augmenter=augmenter,
        factor_sc=P.FACTOR_SC,
        factor_mag=P.FACTOR_MAG,
        scheduler=ReduceLROnPlateau(factor=P.FACTOR, patience=P.PATIENCE),
        early_stopping=EarlyStopping(patience=P.EARLY_STOP, min_delta=P.MIN_DELTA),
        save=args.save,
        monitoring=args.monitoring,
        example_batch=np.asarray(example, np.float32),
        device=device,
    )
    trainer.start_epoch()
    trainer.training_loop()
    return trainer


if __name__ == "__main__":
    main()

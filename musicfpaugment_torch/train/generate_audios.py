"""Denoising demo CLI (port of musicfpaugment_tpu/train/generate_audios.py):
augment a clip, denoise it, write the clean / augmented / denoised wavs and
spectrogram figures.

    python -m musicfpaugment_torch.train.generate_audios --model unet|demucs \
        [--checkpoint DIR] [--out DIR] [--seconds 3] [--device cuda] [--seed 0]

The clean clip is a random window of a validation track where MTG-Jamendo
is mounted (``MFPA_JAMENDO_ROOT``), a synthetic one otherwise. The model is
the trainer's checkpoint (``state.pt`` under ``<checkpoint>/best_epoch``;
default: the train CLI's checkpoint directory for the model), or the JAX
package's random one when there is none (Flax's initial weights under
``PRNGKey(0)``). The denoised wav is written for Demucs (a
waveform denoiser); the UNet denoises spectrograms, so it gets the denoised
figure only. The figures are written when matplotlib imports.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from musicfpaugment_torch.augment.pipeline import AugmentFP, synthetic_banks
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.device import cudnn_tf32, resolve_device
from musicfpaugment_torch.models import Demucs, UNet, flax_init
from musicfpaugment_torch.train import parameters as P
from musicfpaugment_torch.train.trainer import spectrogram_batch

CHECKPOINT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "checkpoints")
LEARNING_RATES = {"unet": 1e-3, "demucs": 5e-4}  # the train CLI's, in the checkpoint name


def _write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    import scipy.io.wavfile

    scipy.io.wavfile.write(path, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))


def load_checkpoint(model: torch.nn.Module, ckpt_path: str, which: str = "best_epoch") -> torch.nn.Module:
    """The model's weights from a :class:`Trainer` checkpoint directory."""
    path = os.path.join(os.path.abspath(ckpt_path), which, "state.pt")
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    return model


def _clean_clip(seconds: int, sr: int, seed: int) -> np.ndarray:
    n = seconds * sr
    try:
        from musicfpaugment_torch.data.dataset import load_track
        from musicfpaugment_torch.data.jamendo import get_jamendo_data

        _, val_paths = get_jamendo_data(
            os.environ.get("MFPA_JAMENDO_ROOT", "/workspace/mtg-jamendo-dataset/"), num_val=64
        )
        audio = load_track(str(val_paths[0]), sr)
        start = int(np.random.default_rng(seed).integers(0, max(1, len(audio) - n)))
        return audio[start : start + n]
    except (ImportError, FileNotFoundError, OSError):
        print("INFO: datasets not mounted — synthesizing a clean clip")
        from musicfpaugment_torch.data.synthetic import synthetic_clean_batches

        return next(synthetic_clean_batches(1, n, sr, seed=seed))[0]


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Runs the demo; returns the paths it wrote."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", default="unet", choices=["unet", "demucs"])
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--out", default="generated_audios")
    parser.add_argument("--seconds", type=int, default=3)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    sr = P.WAVEFORM_SAMPLING_RATE
    os.makedirs(args.out, exist_ok=True)
    clean = _clean_clip(args.seconds, sr, args.seed)

    noise_bank, ir_bank = synthetic_banks(
        sample_rate=sr, noise_row_length=args.seconds * sr, device=device
    )
    augmenter = AugmentFP(noise_bank, sr, impulse_response_dir=ir_bank, device=device)
    clean_t = torch.from_numpy(np.ascontiguousarray(clean, np.float32)).to(device)
    augmented = augmenter(clean_t, key=prng.key(args.seed))

    model = (UNet(1, 1, rate=0.05) if args.model == "unet" else Demucs()).to(device)
    ckpt = args.checkpoint or os.path.join(
        CHECKPOINT_ROOT, f"{args.model}_lr_{LEARNING_RATES[args.model]}_BS_{P.BATCH_SIZE}"
    )
    try:
        load_checkpoint(model, ckpt)
    except FileNotFoundError:
        # the JAX package's random model: Flax's init under PRNGKey(0), no rescale
        print(f"INFO: no checkpoint at {ckpt} — using Flax's initial weights (PRNGKey(0))")
        flax_init(model)
    model = model.eval()

    with torch.no_grad(), cudnn_tf32(False):
        if args.model == "unet":
            den_spec = model(spectrogram_batch(augmented[None]))[0]
            denoised = None
        else:
            denoised = model(augmented[None])[0]
            den_spec = spectrogram_batch(denoised[None])[0]

    written = []
    for name, sig in (("clean", clean_t), ("augmented", augmented), ("denoised", denoised)):
        if sig is not None:
            written.append(os.path.join(args.out, f"{name}.wav"))
            _write_wav(written[-1], sig.detach().cpu().numpy(), sr)
    try:
        import matplotlib.pyplot as plt

        from musicfpaugment_torch.train.visualisation import plot_spectrogram

        specs = {"clean": spectrogram_batch(clean_t[None])[0],
                 "augmented": spectrogram_batch(augmented[None])[0], "denoised": den_spec}
        for name, spec in specs.items():
            written.append(os.path.join(args.out, f"{name}.png"))
            plt.close(plot_spectrogram(spec, written[-1], amplitude=True))
    except ImportError:
        print("INFO: matplotlib not available — skipping figures")
    print(f"Wrote triplets to {args.out}/")
    return written


if __name__ == "__main__":
    main()

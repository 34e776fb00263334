"""TensorBoard monitoring callbacks (port of
musicfpaugment_tpu/train/callbacks.py).

Scalars every epoch; wav and spectrogram triplets (clean / augmented /
denoised) every 10 epochs. ``writer`` is anything with the ``add_scalar``,
``add_audio`` and ``add_image`` calls of
``torch.utils.tensorboard.SummaryWriter``. The arrays keep the JAX
package's layouts: a clip is ``(T, 1)`` (audio ``[..., None]``), an image
``(H, W, 1)``, divided by the triplet member's largest value and flipped so
that low frequencies are at the bottom (``img[:, ::-1]``). A TensorBoard
image or audio summary holds one example here, so example ``i`` of a batch
goes under ``<tag>/<i>``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def monitor_losses(writer, losses: Dict[str, float], datas: str, epoch: int) -> None:
    for key, value in losses.items():
        writer.add_scalar(f"{datas}/{key}", float(value), epoch)


def monitor_metrics(writer, metrics: Dict[str, float], datas: str, epoch: int) -> None:
    for key, value in metrics.items():
        writer.add_scalar(f"{datas}/metric_{key}", float(value), epoch)


def monitor_audios(
    writer, clean, augmented, denoised, epoch: int, datas: str,
    sample_rate: int = 8000, max_outputs: int = 3,
) -> None:
    """The first ``max_outputs`` clips of each waveform triplet member."""
    for name, batch in (("clean", clean), ("augmented", augmented), ("denoised", denoised)):
        audio = _numpy(batch)[:max_outputs][..., None].astype(np.float32)
        for i, clip in enumerate(audio):
            writer.add_audio(f"{datas}/{name}/{i}", clip, epoch, sample_rate=sample_rate)


def monitor_specs(
    writer, clean, augmented, denoised, epoch: int, datas: str, max_outputs: int = 3
) -> None:
    """Spectrogram images of a waveform triplet."""
    from musicfpaugment_torch.train.trainer import spectrogram_batch

    specs = [
        spectrogram_batch(torch.as_tensor(batch, dtype=torch.float32)[:max_outputs])
        for batch in (clean, augmented, denoised)
    ]
    monitor_specs_precomputed(writer, *specs, epoch=epoch, datas=datas, max_outputs=max_outputs)


def monitor_specs_precomputed(
    writer, clean_spec, augmented_spec, denoised_spec, epoch: int, datas: str,
    max_outputs: int = 3,
) -> None:
    """Spectrogram images of a triplet that is already in the spectrogram
    domain (the UNet path: the denoiser's output is a spectrogram)."""
    for name, spec in (
        ("clean", clean_spec), ("augmented", augmented_spec), ("denoised", denoised_spec),
    ):
        spec = _numpy(spec)[:max_outputs].astype(np.float32)
        img = (spec[..., None] / max(float(spec.max()), 1e-9))[:, ::-1, :, :]
        for i, im in enumerate(img):
            writer.add_image(f"{datas}/spec_{name}/{i}", np.ascontiguousarray(im), epoch,
                             dataformats="HWC")

"""The model frontend's spectrogram and its plot (port of
musicfpaugment_tpu/train/visualisation.py)."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from musicfpaugment_torch.train.trainer import spectrogram_batch


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def spectrogram(waveform, amplitude: bool = False) -> Any:
    """The model-frontend STFT (audfprint's STFT parameters) of a (T,) or
    (B, T) waveform, on the waveform's device: a tensor, or with
    ``amplitude`` a numpy array in dB below its largest value."""
    x = torch.as_tensor(waveform, dtype=torch.float32)
    squeeze = x.ndim == 1
    spec = spectrogram_batch(x[None] if squeeze else x)
    if squeeze:
        spec = spec[0]
    if amplitude:
        mag = _numpy(spec)
        ref = mag.max()
        return 20.0 * np.log10(np.maximum(mag, 1e-10) / max(ref, 1e-10))
    return spec


def plot_spectrogram(
    spec, save_path: Optional[str] = None, amplitude: bool = False,
    sample_rate: int = 8000, hop_length: int = 256,
) -> Any:
    """A matplotlib figure of a (bins, frames) spectrogram, saved to
    ``save_path`` if given. Raises ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    spec = _numpy(spec)
    if amplitude:
        ref = spec.max()
        spec = 20.0 * np.log10(np.maximum(spec, 1e-10) / max(ref, 1e-10))
    fig, ax = plt.subplots(figsize=(10, 8))
    extent = [0, spec.shape[-1] * hop_length / sample_rate, 0, sample_rate / 2]
    im = ax.imshow(spec, origin="lower", aspect="auto", extent=extent, cmap="magma")
    ax.set_title("STFT spectrum")
    ax.set_xlabel("Time")
    ax.set_ylabel("Hz")
    plt.colorbar(im, ax=ax, format="%+2.0f dB")
    if save_path is not None:
        plt.savefig(save_path, dpi=300)
    return fig

"""Interactive AugmentFP demo (port of
musicfpaugment_tpu/apps/streamlit_app.py).

Sliders (loudspeaker EQ, room reverb, background-noise SNR, recording-device
gain, clipping and band limits) -> ``AugmentFP`` on the card at 16 kHz ->
playback of the degraded audio. Run with:

    streamlit run musicfpaugment_torch/apps/streamlit_app.py

streamlit is imported by :func:`main` alone, so the module imports without
it; :func:`load_audio` and :func:`define_model` take the ``st`` object.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from musicfpaugment_torch.device import DeviceLike

SAMPLE_RATE = 16000
EXAMPLES_DIR = os.environ.get("MFPA_EXAMPLES_DIR", "/workspace/src/streamlit_app/examples")


def _mono_16k(data: np.ndarray, sr: int) -> np.ndarray:
    from musicfpaugment_torch.data.audio_io import resample

    mono = data.mean(axis=0) if data.shape[0] > 1 else data[0]
    return resample(mono, sr, SAMPLE_RATE)


def load_audio(st) -> Tuple[Optional[np.ndarray], Optional[List[int]]]:
    """Examples picked from ``EXAMPLES_DIR`` and uploaded wav or mp3 files
    (decoded by the port's ``read_wav``, mp3 through libmpg123), as a
    (B, 1, T) batch cut to the shortest, at 16 kHz."""
    from musicfpaugment_torch.data.audio_io import read_wav

    examples = {
        f"Clean {i}": os.path.join(EXAMPLES_DIR, f"{i}_clean.wav")
        for i in range(1, 11)
        if os.path.exists(os.path.join(EXAMPLES_DIR, f"{i}_clean.wav"))
    }
    audio_arrays = []
    if examples:
        for name in st.multiselect("Select from example(s)", list(examples)):
            st.audio(examples[name], format="wav")
            audio_arrays.append(_mono_16k(*read_wav(examples[name])))
    files = st.file_uploader("Upload audio", type=["wav", "mp3"], accept_multiple_files=True)
    for f in files or []:
        suffix = os.path.splitext(f.name)[1].lower() or ".wav"
        st.audio(f, format="audio/mpeg" if suffix == ".mp3" else "wav")
        # the uploader hands over a byte stream; the decoders read paths
        with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
            tmp.write(f.read())
            path = tmp.name
        try:
            audio_arrays.append(_mono_16k(*read_wav(path)))
        finally:
            os.unlink(path)
    if not audio_arrays:
        return None, None
    n = min(a.shape[0] for a in audio_arrays)
    return np.stack([a[:n] for a in audio_arrays])[:, None, :], [SAMPLE_RATE] * len(audio_arrays)


def define_model(st, device: DeviceLike = None):
    """The slider panel -> an ``AugmentFP`` with those parameters on
    ``device`` (``None`` is CUDA): DCASE noise from ``MFPA_NOISE_SPLIT``
    where it exists, synthetic banks otherwise."""
    st.markdown("<h4>Loudspeakers</h4>", unsafe_allow_html=True)
    min_c1, max_c1 = st.slider(
        "-3dB cutoff freq (Hz)", min_value=0, max_value=300, step=1, value=(0, 150)
    )
    st.markdown("<h4>Room</h4>", unsafe_allow_html=True)
    reverb = st.checkbox("Reverb", value=True)
    st.markdown("<h4>Background Noise</h4>", unsafe_allow_html=True)
    min_snr, max_snr = st.slider("SNR (dB)", min_value=-20, max_value=20, step=1, value=(-10, 10))
    st.markdown("<h4>Recording Device</h4>", unsafe_allow_html=True)
    min_gain, max_gain = st.slider("Gain (dB)", min_value=-10, max_value=10, step=1, value=(-5, 5))
    max_clip = st.slider("Clipping", min_value=0.0, max_value=1.0, step=0.01, value=0.01)
    min_lpf, max_lpf = st.slider(
        "Low pass filter: -3dB cutoff frequency (Hz)",
        min_value=2000, max_value=3999, step=1, value=(3000, 3999),
    )
    min_hpf, max_hpf = st.slider(
        "High pass filter: -3dB cutoff frequency (Hz)",
        min_value=0, max_value=300, step=1, value=(30, 150),
    )
    parameters = {
        "proba_cutoff_freq1": 1.0,
        "proba_snr_in_db": 1.0,
        "proba_ir_response": int(reverb),
        "proba_gain_in_db": 1.0,
        "proba_percentile_threshold": 1.0,
        "proba_cutoff_freq2": 1.0,
        "proba_cutoff_freq3": 1.0,
        "min_cutoff_freq1": min_c1,
        "max_cutoff_freq1": max_c1,
        "min_snr_in_db": min_snr,
        "max_snr_in_db": max_snr,
        "min_gain_in_db": min_gain,
        "max_gain_in_db": max_gain,
        "max_percentile_threshold": max_clip,
        "min_cutoff_freq2": min_lpf,
        "max_cutoff_freq2": max_lpf,
        "min_cutoff_freq3": min_hpf,
        "max_cutoff_freq3": max_hpf,
    }
    from musicfpaugment_torch.augment import AugmentFP, synthetic_banks

    split_path = os.environ.get("MFPA_NOISE_SPLIT", "/workspace/src/training/splits/train.json")
    if os.path.exists(split_path):
        with open(split_path) as f:
            noise_paths = json.load(f)
        return AugmentFP(noise_paths, SAMPLE_RATE, parameters, device=device)
    noise_bank, ir_bank = synthetic_banks(sample_rate=SAMPLE_RATE, device=device)
    return AugmentFP(noise_bank, SAMPLE_RATE, parameters, impulse_response_dir=ir_bank, device=device)


def process_audio(audios: np.ndarray, sample_rates, model, key: Optional[torch.Tensor] = None):
    """One ``batch_augment`` call over the (B, 1, T) batch on the
    augmenter's device under ``key`` (default: the augmenter's stream) ->
    one 16-bit wav file's bytes per example."""
    import scipy.io.wavfile

    aug = model.batch_augment(torch.as_tensor(audios, dtype=torch.float32), key=key)
    outputs = []
    for rate, aug_audio in zip(sample_rates, aug.cpu().numpy()):
        buf = io.BytesIO()
        scipy.io.wavfile.write(buf, rate, (np.clip(aug_audio[0], -1, 1) * 32767).astype(np.int16))
        outputs.append(buf.getvalue())
    return outputs


def main() -> None:
    import streamlit as st

    st.title("Music Augmentation for Audio Fingerprinting")
    audios, sample_rates = load_audio(st)
    model = define_model(st)
    if audios is not None and st.button("Augment"):
        outputs = process_audio(audios, sample_rates, model)
        st.markdown("<h4>Augmented</h4>", unsafe_allow_html=True)
        for out in outputs:
            st.audio(out, format="audio/wav")


if __name__ == "__main__":
    main()

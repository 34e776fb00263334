"""The AugmentFP demo app, port against the JAX package's, with a stand-in
``st`` (streamlit is not installed): the module imports without streamlit,
the sliders map to the same ``AugmentFP`` parameters, uploaded wav and mp3
files decode to the same batch, and ``process_audio`` runs on the CPU and
returns wav bytes that decode to finite audio of peak <= 1.
"""

import io
import os

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from musicfpaugment_torch.apps import streamlit_app as tapp
from musicfpaugment_torch.core import prng
from musicfpaugment_torch.data import native
from musicfpaugment_tpu.apps import streamlit_app as japp

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

MP3 = os.path.join(os.path.dirname(__file__), "fixtures", "tone.mp3")


class Upload:
    """A file the uploader hands over: a name and its bytes."""

    def __init__(self, path):
        self.name = os.path.basename(path)
        self._data = open(path, "rb").read()

    def read(self):
        return self._data


class StandIn:
    """The streamlit calls the app makes; sliders answer their default or
    the value given for their label."""

    def __init__(self, values=None, uploads=()):
        self.values = values or {}
        self.uploads = list(uploads)
        self.played = []

    def markdown(self, *args, **kwargs):
        pass

    def slider(self, label, min_value, max_value, step, value):
        return self.values.get(label, value)

    def checkbox(self, label, value):
        return self.values.get(label, value)

    def multiselect(self, label, options):
        return []

    def file_uploader(self, label, type, accept_multiple_files):
        return [Upload(u) for u in self.uploads]

    def audio(self, data, format):
        self.played.append(format)


@pytest.mark.parametrize("values", [
    {},
    {"-3dB cutoff freq (Hz)": (10, 200), "Reverb": False, "SNR (dB)": (-3, 12),
     "Gain (dB)": (-2, 1), "Clipping": 0.2, "Low pass filter: -3dB cutoff frequency (Hz)": (2500, 3500),
     "High pass filter: -3dB cutoff frequency (Hz)": (50, 100)},
])
def test_slider_parameters_equal_jax(values):
    model = tapp.define_model(StandIn(values), device="cpu")
    j_model = japp.define_model(StandIn(values))
    assert model.parameters == j_model.parameters
    assert model.sample_rate == j_model.sample_rate == 16000 and model.device == torch.device("cpu")
    assert model.parameters["proba_ir_response"] == (0 if values else 1)


def test_uploads_decode_like_jax(tmp_path):
    if not native.mp3_available():
        pytest.skip("libmpg123.so.0 cannot be loaded")
    sr = 22050
    t = np.arange(3 * sr) / sr
    wav = str(tmp_path / "a.wav")
    scipy.io.wavfile.write(wav, sr, (0.4 * np.sin(2 * np.pi * 330 * t) * 32767).astype(np.int16))
    st = StandIn(uploads=[wav, MP3])
    audios, rates = tapp.load_audio(st)
    j_audios, j_rates = japp.load_audio(StandIn(uploads=[wav, MP3]))
    assert audios.shape == j_audios.shape and audios.shape[:2] == (2, 1) and rates == j_rates == [16000] * 2
    np.testing.assert_array_equal(audios, j_audios)
    assert st.played == ["wav", "audio/mpeg"]
    assert tapp.load_audio(StandIn()) == (None, None)


def test_process_audio_on_the_cpu():
    model = tapp.define_model(StandIn(), device="cpu")
    x = np.random.default_rng(2).uniform(-0.5, 0.5, (4, 1, 16000)).astype(np.float32)
    outs = tapp.process_audio(x, [16000] * 4, model, key=prng.key(0))
    assert len(outs) == 4
    for out in outs:
        sr, y = scipy.io.wavfile.read(io.BytesIO(out))
        y = y.astype(np.float32) / 32767
        assert sr == 16000 and y.shape == (16000,) and np.isfinite(y).all() and np.abs(y).max() <= 1.0
    again = tapp.process_audio(x, [16000] * 4, model, key=prng.key(0))
    assert again == outs


def test_main_needs_streamlit():
    import importlib.util

    if importlib.util.find_spec("streamlit") is not None:
        pytest.skip("streamlit is installed: main() would draw the page")
    with pytest.raises(ImportError):
        tapp.main()

"""Evaluation configuration: the audfprint engine settings, copied verbatim
from musicfpaugment_tpu/testing/parameters.py so results are comparable."""

WAVEFORM_SAMPLING_RATE = 8000

afp_settings = {
    "audfprint": {
        "density": 20,
        "pks-per-frame": 5,
        "freq-sd": 30,
        "shifts": 1,
        "samplerate": 8000,
        "n_fft": 512,
        "n_hop": 256,
    },
}

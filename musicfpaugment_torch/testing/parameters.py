"""Evaluation configuration: query directories for the 11 conditions, the
audfprint and dejavu engine settings, the database locations and the 10 per-condition
AugmentFP parameter dicts used to synthesize degraded queries. Values are
copied verbatim from musicfpaugment_tpu/testing/parameters.py so results are
comparable; paths are overridable via environment variables."""

import os

WAVEFORM_SAMPLING_RATE = 8000

_QUERIES_ROOT = os.environ.get("MFPA_QUERIES_ROOT", "/workspace/queries")

queries_paths = {
    "cleans": f"{_QUERIES_ROOT}/cleans",
    "bn_m10": f"{_QUERIES_ROOT}/bn_m10",
    "bn_m5": f"{_QUERIES_ROOT}/bn_m5",
    "bn_0": f"{_QUERIES_ROOT}/bn_0",
    "bn_p5": f"{_QUERIES_ROOT}/bn_p5",
    "bn_p10": f"{_QUERIES_ROOT}/bn_p10",
    "reverb": f"{_QUERIES_ROOT}/reverb",
    "recording_device": f"{_QUERIES_ROOT}/recording_device",
    "full_light": f"{_QUERIES_ROOT}/full_light",
    "full_hard": f"{_QUERIES_ROOT}/full_hard",
    "default_parameters": f"{_QUERIES_ROOT}/default_parameters",
}

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
    "dejavu": {
        "samplerate": 8000,
        "n_fft": 512,
        "n_hop": int(0.5 * 512),
        # Degree to which a fingerprint can be paired with its neighbors —
        # higher values cause more fingerprints but potentially better accuracy.
        "fan_value": 3,
        "amp_min": 50,
        "peak_neighb_size": 10,
    },
}

afp_db_paths = {
    "audfprint": os.environ.get(
        "MFPA_AUDFPRINT_DB", "/workspace/afp/fp_database.npz"
    ),
    "dejavu": {
        "database": {
            "host": os.environ.get("MFPA_DEJAVU_HOST", "db_fma"),
            "user": "postgres",
            "password": "password",
            "database": "dejavu_fma",
        },
    },
}


def _condition(**overrides):
    base = {
        "proba_cutoff_freq1": 0,
        "proba_snr_in_db": 0,
        "proba_ir_response": 0,
        "proba_gain_in_db": 0,
        "proba_percentile_threshold": 0,
        "proba_cutoff_freq2": 0,
        "proba_cutoff_freq3": 0,
        "min_snr_in_db": 0,
        "max_snr_in_db": 0,
        "min_cutoff_freq1": 0.0,
        "max_cutoff_freq1": 0.1,
        "min_gain_in_db": 0,
        "max_gain_in_db": 0.1,
        "max_percentile_threshold": 0.1,
        "min_cutoff_freq2": 0,
        "max_cutoff_freq2": 0.1,
        "min_cutoff_freq3": 0,
        "max_cutoff_freq3": 0.1,
    }
    base.update(overrides)
    return base


# Background-noise-only conditions at fixed SNR
bn_m10_params = _condition(proba_snr_in_db=1, min_snr_in_db=-10, max_snr_in_db=-10)
bn_m5_params = _condition(proba_snr_in_db=1, min_snr_in_db=-5, max_snr_in_db=-5)
bn_0_params = _condition(proba_snr_in_db=1, min_snr_in_db=0, max_snr_in_db=0)
bn_p5_params = _condition(proba_snr_in_db=1, min_snr_in_db=5, max_snr_in_db=5)
bn_p10_params = _condition(proba_snr_in_db=1, min_snr_in_db=10, max_snr_in_db=10)

# Reverb alone
reverb_params = _condition(proba_ir_response=1)

# Recording device chain: gain + clipping + LPF + HPF
recording_device_params = _condition(
    proba_gain_in_db=1,
    proba_percentile_threshold=1,
    proba_cutoff_freq2=1,
    proba_cutoff_freq3=1,
    min_gain_in_db=-5.0,
    max_gain_in_db=5.0,
    max_percentile_threshold=0.01,
    min_cutoff_freq2=3000,
    max_cutoff_freq2=3999,
    min_cutoff_freq3=30,
    max_cutoff_freq3=150,
)

# Full pipelines
light_parameters = {
    "proba_cutoff_freq1": 1,
    "proba_snr_in_db": 1,
    "proba_ir_response": 1,
    "proba_gain_in_db": 1,
    "proba_percentile_threshold": 1,
    "proba_cutoff_freq2": 1,
    "proba_cutoff_freq3": 1,
    "min_cutoff_freq1": 0,
    "max_cutoff_freq1": 30,
    "min_snr_in_db": 0,
    "max_snr_in_db": 5,
    "min_gain_in_db": -0.5,
    "max_gain_in_db": 0.5,
    "max_percentile_threshold": 0.0001,
    "min_cutoff_freq2": 3500,
    "max_cutoff_freq2": 3999,
    "min_cutoff_freq3": 0,
    "max_cutoff_freq3": 20,
}

hard_parameters = {
    "proba_cutoff_freq1": 1,
    "proba_snr_in_db": 1,
    "proba_ir_response": 1,
    "proba_gain_in_db": 1,
    "proba_percentile_threshold": 1,
    "proba_cutoff_freq2": 1,
    "proba_cutoff_freq3": 1,
    "min_cutoff_freq1": 0,
    "max_cutoff_freq1": 150,
    "min_snr_in_db": -5,
    "max_snr_in_db": 0,
    "min_gain_in_db": -5,
    "max_gain_in_db": 5,
    "max_percentile_threshold": 0.01,
    "min_cutoff_freq2": 3000,
    "max_cutoff_freq2": 3500,
    "min_cutoff_freq3": 30,
    "max_cutoff_freq3": 150,
}

default_parameters = {
    "proba_cutoff_freq1": 1,
    "proba_snr_in_db": 1,
    "proba_ir_response": 1,
    "proba_gain_in_db": 1,
    "proba_percentile_threshold": 1,
    "proba_cutoff_freq2": 1,
    "proba_cutoff_freq3": 1,
    "min_cutoff_freq1": 0.0,
    "max_cutoff_freq1": 150.0,
    "min_snr_in_db": -10,
    "max_snr_in_db": 10,
    "min_gain_in_db": -5.0,
    "max_gain_in_db": 5.0,
    "max_percentile_threshold": 0.01,
    "min_cutoff_freq2": 3000.0,
    "max_cutoff_freq2": 3999.0,
    "min_cutoff_freq3": 30.0,
    "max_cutoff_freq3": 150.0,
}

test_pipelines_parameters = {
    "bn_m10": bn_m10_params,
    "bn_m5": bn_m5_params,
    "bn_0": bn_0_params,
    "bn_p5": bn_p5_params,
    "bn_p10": bn_p10_params,
    "reverb": reverb_params,
    "recording_device": recording_device_params,
    "full_light": light_parameters,
    "full_hard": hard_parameters,
    "default_parameters": default_parameters,
}

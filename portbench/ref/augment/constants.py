"""AugmentFP default parameters, values verbatim from
musicfpaugment_tpu/augment/constants.py: probabilities all 0.8, HPF1
0-150 Hz, SNR -10..10 dB, gain +/-5 dB, clip <=1%, LPF 3000-3999 Hz, HPF3
30-150 Hz, 8 kHz waveforms, MIT IR survey directory.
"""

IMPULSE_RESPONSE_DIR = "/workspace/noise_databases/mit_ir_survey/Audio"

DEFAULT_PARAMETERS = {
    "proba_cutoff_freq1": 0.8,
    "proba_snr_in_db": 0.8,
    "proba_ir_response": 0.8,
    "proba_gain_in_db": 0.8,
    "proba_percentile_threshold": 0.8,
    "proba_cutoff_freq2": 0.8,
    "proba_cutoff_freq3": 0.8,
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

WAVEFORM_SAMPLING_RATE = 8000

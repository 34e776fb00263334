"""Dejavu constants (the port's own copy of
musicfpaugment_tpu/afp/dejavu/variables.py, values verbatim)."""

CONNECTIVITY_MASK = 2
PEAK_NEIGHBORHOOD_SIZE = 10  # 20 was the original value.
MIN_HASH_TIME_DELTA = 0
MAX_HASH_TIME_DELTA = 200
FINGERPRINT_REDUCTION = 20

OFFSET = "offset"
OFFSET_SECS = "offset_seconds"

SONG_ID = "song_id"
SONG_NAME = "song_name"
INPUT_HASHES = "input_total_hashes"
FINGERPRINTED_HASHES = "fingerprinted_hashes_in_db"
HASHES_MATCHED = "hashes_matched_in_input"
INPUT_CONFIDENCE = "input_confidence"
INPUT_CONFIDENCE_2 = "input_confidence_2"
FINGERPRINTED_CONFIDENCE = "fingerprinted_confidence"

TOPN = 1
MIN_HASHES = 1
RESULTS = "results"

"""The matcher's lane tier a ``match_waveforms`` call, ``matcher.lane_tier`` (``spans.counter``)."""

from portbench import spans as S


def read(run):
    return S.counter(run, "audfprint.batch", "matcher.lane_tier", per="matcher.match_waveforms")

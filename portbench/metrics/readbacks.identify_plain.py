"""The matcher's device-to-host readbacks a batch, ``matcher.readbacks`` (``spans.counter``)."""

from portbench import spans as S


def read(run):
    return S.counter(run, "audfprint.batch", "matcher.readbacks")

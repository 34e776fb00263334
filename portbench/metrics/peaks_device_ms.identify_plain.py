"""Device self ms of ``matcher.peaks`` a batch (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "audfprint.batch", ["matcher.peaks"], "device_self_ms")

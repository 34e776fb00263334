"""Device ms of ``matcher.match`` a batch (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "audfprint.batch", ["matcher.match"], "device_ms")

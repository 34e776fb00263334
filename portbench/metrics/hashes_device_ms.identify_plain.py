"""Device ms of ``matcher.hashes`` a batch (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "audfprint.batch", ["matcher.hashes"], "device_ms")

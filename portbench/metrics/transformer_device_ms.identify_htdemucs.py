"""Device ms of HTDemucs' cross-domain Transformer, ``htdemucs.transformer``,
a batch (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "audfprint.batch", ["htdemucs.transformer"], "device_ms")

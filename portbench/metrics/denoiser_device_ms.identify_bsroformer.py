"""Device ms of ``denoiser.forward`` a batch (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "audfprint.batch", ["denoiser.forward"], "device_ms")

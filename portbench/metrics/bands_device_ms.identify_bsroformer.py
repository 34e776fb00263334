"""Device ms of BS-RoFormer's two 62-way per-band loops a batch: the band
split (``bsroformer.band_split``) and the mask MLPs with the last RMSNorm
and the complex product (``bsroformer.mask``) (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "audfprint.batch", ["bsroformer.band_split", "bsroformer.mask"],
                      "device_ms")

"""Device ms of BS-RoFormer's axial Transformer (its 12 blocks),
``bsroformer.transformer``, a batch (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "audfprint.batch", ["bsroformer.transformer"], "device_ms")

"""Tokens entering BS-RoFormer's Transformer a batch, examples x frames x
bands, ``bsroformer.tokens`` (``spans.counter``)."""

from portbench import spans as S


def read(run):
    return S.counter(run, "audfprint.batch", "bsroformer.tokens")

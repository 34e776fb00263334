"""Tokens entering HTDemucs' Transformer a batch, spectral plus temporal,
``htdemucs.tokens`` (``spans.counter``)."""

from portbench import spans as S


def read(run):
    return S.counter(run, "audfprint.batch", "htdemucs.tokens")

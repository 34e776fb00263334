"""Host ms of ``augment.draw`` and ``augment.apply`` a step (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "trainer.step", ["augment.draw", "augment.apply"], "host_ms")

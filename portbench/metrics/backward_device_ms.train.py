"""Device ms of ``trainer.backward`` a step (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "trainer.step", ["trainer.backward"], "device_ms")

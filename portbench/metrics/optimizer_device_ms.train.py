"""Device ms of ``trainer.optimizer`` a step (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "trainer.step", ["trainer.optimizer"], "device_ms")

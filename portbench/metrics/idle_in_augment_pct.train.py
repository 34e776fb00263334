"""The share of device-idle time with ``augment.draw`` or
``augment.apply`` the innermost span (``spans.idle_share``)."""

from portbench import spans as S


def read(run):
    return S.idle_share(run, "trainer.step", ["augment.draw", "augment.apply"])

"""Host self ms of the driver's ``audfprint.batch`` span a batch (``spans.per_root``)."""

from portbench import spans as S


def read(run):
    return S.per_root(run, "audfprint.batch", ["audfprint.batch"], "host_self_ms")

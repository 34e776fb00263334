"""The share of device-idle time with ``audfprint.batch`` the innermost
span (``spans.idle_share``)."""

from portbench import spans as S


def read(run):
    return S.idle_share(run, "audfprint.batch", ["audfprint.batch"])

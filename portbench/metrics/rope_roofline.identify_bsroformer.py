"""The rotary kernel's (``csrc/rope_qk.cu``) share of its roofline in the
profiled slice: the least time the bytes its launches read and write need at
the card's byte rate (``bsroformer.rope_bytes``, counted at each launch:
q and k read once and written once, and the two tables), over the summed
device time of the trace's ``rope_qk_kernel`` events. Nothing is read where
the trace's launches are not the program's count of them
(``bsroformer.rope_launches``), nor on a program without those counters."""

from portbench import harness as H
from portbench import spans as S

ROOT = "audfprint.batch"


def read(run):
    trace = run.layer.get("trace")
    got = S.slice_spans(run, ROOT)
    if not trace or got is None:
        return None
    roots = got[1]
    launches = S.counter(run, ROOT, "bsroformer.rope_launches")
    nbytes = S.counter(run, ROOT, "bsroformer.rope_bytes")
    if not launches or not nbytes:
        return None
    secs, n = H.device_seconds(trace, lambda name: "rope_qk_kernel" in name)
    if n == 0 or n != round(launches * roots):
        return None
    return 100.0 * nbytes * roots / H.HBM_BYTES_PER_S / secs

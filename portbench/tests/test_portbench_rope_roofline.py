"""The rotary kernel's roofline reader (``metrics/rope_roofline.identify_bsroformer.py``)
on a made-up slice of two batches: the counted bytes of both batches at the
card's byte rate over the kernel's device time, and nothing where the trace's
launches are not the counted ones or the program counts nothing."""

from __future__ import annotations

import os

import pytest

from portbench import harness as H
from portbench import spans as S

NAME = "rope_roofline.identify_bsroformer"
KERNEL = "void (anonymous namespace)::rope_qk_kernel(float4 const*, float4 const*)"
LAUNCHES, BYTES = 24, 3.35e9  # a batch: 1 ms of bytes at the byte rate


class _Run:
    def __init__(self, trace):
        self.layer, self.device = {"trace": trace}, "cuda"


def _reader():
    path = os.path.join(H.BENCH_DIR, "metrics", NAME + ".py")
    return H.load_file_module(path, "portbench_metric_rope_roofline_test")


def _slice(monkeypatch, counts):
    recs = []
    for b in range(2):
        root = 10 * b
        recs.append({"name": "audfprint.batch", "id": root, "parent": None, "root": root,
                     "counts": {}})
        recs.append({"name": "bsroformer.transformer", "id": root + 1, "parent": root,
                     "root": root, "counts": dict(counts)})
    monkeypatch.setattr(S, "_profiling",
                        lambda: type("P", (), {"spans": staticmethod(lambda: recs)}))


def _trace(launches, us_each):
    return {"host": [(0.0, 1.0, "audfprint.batch"), (2.0, 1.0, "audfprint.batch")],
            "device": [(float(i), us_each, KERNEL) for i in range(launches)]
            + [(0.0, 500.0, "sm80_xmma_gemm_f32f32")], "window_s": 1.0}


@pytest.mark.parametrize("us_each,want", [(1000.0 / LAUNCHES, 100.0),
                                          (2000.0 / LAUNCHES, 50.0)])
def test_counted_bytes_over_the_kernels_device_time(monkeypatch, us_each, want):
    _slice(monkeypatch, {"bsroformer.rope_launches": LAUNCHES, "bsroformer.rope_bytes": BYTES})
    got = _reader().read(_Run(_trace(2 * LAUNCHES, us_each)))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("case", ["launches_differ", "no_counters", "no_kernel"])
def test_reads_nothing_where_it_cannot_match_the_launches(monkeypatch, case):
    counts = {"bsroformer.rope_launches": LAUNCHES, "bsroformer.rope_bytes": BYTES}
    launches = 2 * LAUNCHES
    if case == "launches_differ":
        launches -= 1
    elif case == "no_counters":
        counts = {"bsroformer.tokens": 1}
    else:
        launches = 0
    _slice(monkeypatch, counts)
    assert _reader().read(_Run(_trace(launches, 10.0))) is None

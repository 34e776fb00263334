"""The readers of the program's own spans and counters (``portbench/spans.py``)
on the CPU at small sizes: a traced run reports them, and a run whose
program records no spans (its ``annotate`` the no-op, as in a program
without them) leaves them out rather than reading 0. The device-time
readers read nothing off the card."""

from __future__ import annotations

import pytest
import torch

from portbench import harness as H
from portbench import spans as S
from portbench.tests import tiny

HOST_READ = {
    "unet64-identify-plain": {"driver_host_ms.identify_plain", "readbacks.identify_plain",
                              "lane_tier.identify_plain"},
    "unet64-train": {"augment_span_host_ms.train"},
}
SPAN_METRICS = {m["name"] for m in H.load_manifest()["per_layer"]
                if m["source"] in ("program_span", "program_counter")}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def input_cache(tmp_path_factory):
    keep = H.CACHE_DIR
    H.CACHE_DIR = str(tmp_path_factory.mktemp("portbench_cache"))
    yield
    H.CACHE_DIR = keep


@pytest.mark.parametrize("spans_on", [True, False], ids=["spans", "no_spans"])
@pytest.mark.parametrize("cell", sorted(HOST_READ))
def test_traced_run_reads_the_programs_spans(cell, spans_on, monkeypatch):
    from musicfpaugment_torch.utils import profiling

    if not spans_on:
        # the program's spans see no profile: ``annotate`` gives the no-op
        monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    rc, line, err = tiny.run_cell(cell, trace=1)
    assert rc == 0 and line["correct"] is True, err[-3000:]
    read = set(line["metrics"]) & SPAN_METRICS
    assert read == (HOST_READ[cell] if spans_on else set()), err[-3000:]
    if spans_on and cell == "unet64-identify-plain":
        # one arm: the tier's two scalars, the match's overflow count, the
        # verdicts' two arrays
        assert line["metrics"]["readbacks.identify_plain"]["value"] == 5
        assert line["metrics"]["lane_tier.identify_plain"]["value"] >= 64


class _Run:
    def __init__(self, trace, device="cuda"):
        self.layer, self.device = {"trace": trace}, device


def _record(name, id_, parent, device_ms, counts=None):
    return {"name": name, "id": id_, "parent": parent, "root": 0 if parent is not None else id_,
            "host_ms": 1.0, "host_self_ms": 1.0, "device_ms": device_ms,
            "device_self_ms": device_ms, "counts": counts or {}}


def test_idle_time_goes_to_the_innermost_open_span(monkeypatch):
    """A batch span over 0-100 us with a peaks span over 20-50 us inside
    it, the device busy over 10-15, 30-40, 60-80 and 110-120 us: of 75 us
    idle, 45 fall to the batch span alone, 20 to the peaks span and 10
    outside every span."""
    recs = [_record("audfprint.batch", 0, None, 0.1, {"matcher.readbacks": 1}),
            _record("matcher.peaks", 1, 0, 0.03, {"matcher.readbacks": 4})]
    monkeypatch.setattr(S, "_profiling", lambda: type("P", (), {"spans": staticmethod(lambda: recs)}))
    trace = {"host": [(0.0, 100.0, "audfprint.batch"), (20.0, 30.0, "matcher.peaks"),
                      (25.0, 5.0, "aten::add")],
             "device": [(10.0, 5.0, "k"), (30.0, 10.0, "k"), (60.0, 20.0, "k"), (110.0, 10.0, "k")],
             "window_s": 120e-6}
    run = _Run(trace)
    by = S.idle_by_span(run, "audfprint.batch")
    assert by == pytest.approx({"audfprint.batch": 45e-6, "matcher.peaks": 20e-6, None: 10e-6})
    assert S.idle_share(run, "audfprint.batch", ["audfprint.batch"]) == pytest.approx(60.0)
    assert S.per_root(run, "audfprint.batch", ["matcher.peaks"], "device_ms") == 0.03
    assert S.per_root(_Run(trace, "cpu"), "audfprint.batch", ["matcher.peaks"], "device_ms") is None
    assert S.counter(run, "audfprint.batch", "matcher.readbacks") == 5
    assert S.counter(run, "audfprint.batch", "matcher.lane_tier") is None
    assert S.per_root(_Run(dict(trace, host=[])), "audfprint.batch", ["matcher.peaks"],
                      "host_ms") is None

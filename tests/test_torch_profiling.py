"""The port's tracing and stage timers (CPU): the same summary as the JAX
package's ``StageTimer``; a trace that holds the annotated region."""

import json
import os

import torch

from musicfpaugment_torch.utils import StageTimer, annotate, trace
from musicfpaugment_tpu.utils.profiling import StageTimer as JStageTimer


def test_stage_timer_summary_has_the_jax_layout():
    got, want = StageTimer(device="cpu"), JStageTimer()
    for timer in (got, want):
        for name in ("load", "load", "match"):
            with timer.stage(name):
                sum(range(1000))
    assert got.summary().keys() == want.summary().keys() == {"load", "match"}
    for name, row in got.summary().items():
        assert row.keys() == want.summary()[name].keys()
        assert row["count"] == want.summary()[name]["count"]
        assert row["total_s"] > 0 and abs(row["mean_ms"] - 1e3 * row["total_s"] / row["count"]) < 1e-9


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        with annotate("demucs_frontend"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    assert "demucs_frontend" in [e.key for e in prof.key_averages()]
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "demucs_frontend" for e in events)
    assert os.listdir(log_dir) == ["trace.json"]

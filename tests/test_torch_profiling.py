"""The port's tracing and stage timers (CPU): the same summary as the JAX
package's ``StageTimer``; a trace that holds the annotated region; spans
and counters that record only under a profile, with their parents, roots,
self times and cap; the matcher's and the trainer's spans on their path."""

import contextlib
import json
import os

import pytest
import torch

from musicfpaugment_torch.utils import StageTimer, annotate, profiling, trace
from musicfpaugment_tpu.utils.profiling import StageTimer as JStageTimer

from torch_port_helpers import few_threads  # noqa: F401

SR = 8000


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


# ------------------------------------------------------------ spans and counters


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("traced", [False, True])
def test_spans_and_counters_record_only_under_a_profile(traced, tmp_path):
    with trace(str(tmp_path)) if traced else contextlib.nullcontext():
        span = annotate("outer")
        with span:
            profiling.count("things", 3)
    assert (span is profiling.NO_SPAN) is not traced
    assert profiling.counters() == ({"things": 3} if traced else {})
    assert [s["name"] for s in profiling.spans()] == (["outer"] if traced else [])
    if traced:
        assert profiling.spans()[0]["counts"] == {"things": 3}


def test_nested_spans_have_their_parent_and_root_and_self_times_add_up(tmp_path):
    with trace(str(tmp_path)):
        for _ in range(2):
            with annotate("root"):
                with annotate("a"):
                    with annotate("a.inner"):
                        torch.randn(64, 64) @ torch.randn(64, 64)
                with annotate("b"):
                    sum(range(1000))
    recs = profiling.spans()
    assert [r["name"] for r in recs] == ["root", "a", "a.inner", "b"] * 2
    for first in (0, 4):
        root, a, inner, b = recs[first:first + 4]
        assert root["parent"] is None and root["root"] == root["id"]
        assert a["parent"] == root["id"] and b["parent"] == root["id"]
        assert inner["parent"] == a["id"]
        assert {r["root"] for r in (a, inner, b)} == {root["id"]}
        tree = sum(r["host_self_ms"] for r in (root, a, inner, b))
        assert tree == pytest.approx(root["host_ms"], rel=1e-9)
        assert all(r["host_self_ms"] >= 0 and r["device_ms"] is None for r in (root, a, inner, b))
    summary = profiling.summary()
    assert summary["a"]["count"] == 2
    assert summary["root"]["host_ms"] == pytest.approx(recs[0]["host_ms"] + recs[4]["host_ms"])


def test_spans_past_the_cap_are_counted_as_dropped(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 3)
    with trace(str(tmp_path)):
        for i in range(5):
            with annotate(f"s{i}"):
                pass
    assert [s["name"] for s in profiling.spans()] == ["s0", "s1", "s2"]
    assert profiling.dropped() == 2
    profiling.reset()
    assert profiling.dropped() == 0 and profiling.spans() == []


def test_span_names_are_user_annotations_in_the_chrome_trace(tmp_path):
    with trace(str(tmp_path)):
        with annotate("matcher.match_waveforms"):
            with annotate("matcher.peaks"):
                torch.randn(8, 8).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"matcher.match_waveforms", "matcher.peaks"} <= names


@pytest.fixture(scope="module")
def tiny_matcher(few_threads):  # noqa: F811
    from musicfpaugment_torch.afp.audfprint import DeviceMatcher, HashTable
    from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
    from musicfpaugment_torch.testing.audfprint_exps import create_fp_database

    tracks = torch.from_numpy(next(synthetic_clean_batches(4, 10 * SR, seed=300)))
    ht = create_fp_database(list(tracks), None, hash_tab=HashTable(depth=4),
                            names=[f"t{i}" for i in range(4)], device="cpu", num_workers=1)
    return DeviceMatcher(ht, device="cpu"), tracks[:, SR:5 * SR].contiguous()


def test_match_waveforms_records_its_stages_and_readbacks(tiny_matcher, tmp_path):
    dm, crops = tiny_matcher
    with trace(str(tmp_path)):
        verdicts = dm.match_waveforms(crops, shifts=2)
    assert [v[:2] for v in verdicts] == [("MATCH", f"t{i}") for i in range(4)]
    recs = profiling.spans()
    top = recs[0]
    assert top["name"] == "matcher.match_waveforms" and top["parent"] is None
    children = [r["name"] for r in recs if r["parent"] == top["id"]]
    assert children == ["matcher.peaks", "matcher.hashes", "matcher.tier", "matcher.match",
                        "matcher.verdicts"]
    # the tier's two scalars, the match's overflow count, the verdicts' two arrays
    assert profiling.counters()["matcher.readbacks"] == 5
    assert profiling.counters()["matcher.lane_tier"] >= 64
    assert next(r for r in recs if r["name"] == "matcher.tier")["counts"] == {"matcher.readbacks": 2}


def test_train_step_records_the_augmenter_and_the_step_stages(few_threads, tmp_path):  # noqa: F811
    from musicfpaugment_torch.augment import AugmentFP, synthetic_banks
    from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
    from musicfpaugment_torch.models import UNet
    from musicfpaugment_torch.train.trainer import Trainer

    noise_bank, ir_bank = synthetic_banks(SR, num_noise=2, num_irs=2, noise_row_length=SR,
                                          device="cpu")
    fp = AugmentFP(noise_bank, SR, impulse_response_dir=ir_bank, device="cpu")
    trainer = Trainer(UNet(1, 1, rate=0.05, base=4), iter(()), 1, iter(()), 1, 1e-3, 1,
                      str(tmp_path / "ckpt"), input_type="spec", augmenter=fp, device="cpu")
    clean = torch.from_numpy(next(synthetic_clean_batches(2, SR, seed=5)))
    with trace(str(tmp_path / "trace")):
        trainer.train_step(clean)
    recs = profiling.spans()
    step = recs[0]
    assert step["name"] == "trainer.step" and step["parent"] is None
    children = [r["name"] for r in recs if r["parent"] == step["id"]]
    assert children == ["augment.draw", "augment.apply", "trainer.forward", "trainer.backward",
                        "trainer.optimizer"]
    assert {r["root"] for r in recs} == {step["id"]}

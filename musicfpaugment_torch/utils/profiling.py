"""Tracing, spans, counters and stage timing (port of
musicfpaugment_tpu/utils/profiling.py).

``trace(log_dir)`` runs ``torch.profiler`` over a block and writes its Chrome
trace. ``annotate(name)`` is the program's span and ``count(name, n)`` its
counter; both record only while a ``torch.profiler`` profile is active
(``trace``, or any other profile), and cost one check otherwise. A span
shows in the profiler's trace as a ``user_annotation`` event, on the same
clock as the card's kernels, and is kept in memory with its parent, its
root, its host interval and a pair of CUDA events on the current stream:
``spans()``, ``summary()``, ``counters()`` read them and ``reset()`` clears
them. ``StageTimer`` times named stages on the host's clock, or on the
card's when it is given a CUDA device.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from musicfpaugment_torch.device import DeviceLike

# spans kept in memory at most; later ones are counted in ``dropped()``
MAX_RECORDS = 100_000

_profiler_enabled = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the host and, where there is one, the card inside the block;
    the Chrome trace (viewable in Perfetto or ``chrome://tracing``) is
    written to ``log_dir/trace.json``. Yields the profiler, whose
    ``key_averages()`` sum the time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _NoSpan:
    """The span while tracing is off: records nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _Record:
    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "events", "device_ms", "counts")

    def __init__(self, name: str, id_: int, parent: Optional["_Record"]) -> None:
        self.name, self.id = name, id_
        self.parent = None if parent is None else parent.id
        self.root = id_ if parent is None else parent.root
        self.t0 = self.t1 = 0
        self.events = None
        self.device_ms: Optional[float] = None
        self.counts: Dict[str, int] = {}


class _Recorder:
    """The process's spans and counters, and each thread's open spans."""

    def __init__(self) -> None:
        self.records: List[_Record] = []
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        self.ids = itertools.count()
        self.local = threading.local()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORDER = _Recorder()


def _cuda_events() -> bool:
    """Whether a span times itself on the card: the program has used CUDA
    and the current stream is not being captured into a graph."""
    return torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing()


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        stack = _RECORDER.stack()
        parent = stack[-1] if stack else None
        rec = None
        if len(_RECORDER.records) < MAX_RECORDS:
            rec = _Record(self.name, next(_RECORDER.ids), parent)
            _RECORDER.records.append(rec)
            rec.t0 = time.perf_counter_ns()
        else:
            _RECORDER.dropped += 1
        stack.append(rec)
        self.rec = rec
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if rec is not None and _cuda_events():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start, None)

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        if rec is not None and rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.events = (rec.events[0], end)
        self.rf.__exit__(*exc)
        if rec is not None:
            rec.t1 = time.perf_counter_ns()
        _RECORDER.stack().pop()
        return False


def annotate(name: str):
    """The program's span over a ``with`` block. While a ``torch.profiler``
    profile is active it opens a ``record_function(name)`` (a
    ``user_annotation`` event in the profiler's trace), records CUDA
    timing events on the current stream at its start and end (without
    synchronising; not while CUDA is unused or the stream is capturing) and
    keeps a record: name, id, parent (the span open around it on this
    thread), root (the outermost span, the batch or step that caused it)
    and host interval. Otherwise it returns the shared no-op ``NO_SPAN``."""
    if not _profiler_enabled():
        return NO_SPAN
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to the innermost open span's
    counts, while a profile is active; nothing otherwise."""
    if not _profiler_enabled():
        return
    _RECORDER.counters[name] = _RECORDER.counters.get(name, 0) + n
    stack = _RECORDER.stack()
    if stack and stack[-1] is not None:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def spans() -> List[dict]:
    """The closed spans in the order they opened, each with ``host_ms`` and
    ``device_ms`` and their self times (the span's time less what its
    children's spans cover), and its ``counts``. ``device_ms`` is the
    stream's time from the span's start event to its end event, None
    without CUDA events: for a span that launches nothing (the augmenter's
    draws on the host) it is the time the card waited on the span. Call
    it once the card has finished the spans' work (each end event is
    waited for)."""
    recs = [r for r in _RECORDER.records if r.t1]
    for r in recs:
        if r.device_ms is None and r.events is not None and r.events[1] is not None:
            start, end = r.events
            end.synchronize()
            r.device_ms = start.elapsed_time(end)
            r.events = None
    child_host: Dict[int, float] = {}
    child_dev: Dict[int, float] = {}
    for r in recs:
        if r.parent is not None:
            child_host[r.parent] = child_host.get(r.parent, 0.0) + (r.t1 - r.t0) / 1e6
            if r.device_ms is not None:
                child_dev[r.parent] = child_dev.get(r.parent, 0.0) + r.device_ms
    out = []
    for r in recs:
        host_ms = (r.t1 - r.t0) / 1e6
        out.append({
            "name": r.name, "id": r.id, "parent": r.parent, "root": r.root,
            "host_start_ns": r.t0, "host_end_ns": r.t1,
            "host_ms": host_ms, "host_self_ms": host_ms - child_host.get(r.id, 0.0),
            "device_ms": r.device_ms,
            "device_self_ms": None if r.device_ms is None
            else r.device_ms - child_dev.get(r.id, 0.0),
            "counts": dict(r.counts),
        })
    return out


def summary() -> Dict[str, Dict[str, Optional[float]]]:
    """Per span name: ``count`` and the summed ``host_ms``,
    ``host_self_ms``, ``device_ms`` and ``device_self_ms`` (None where no
    span of the name has CUDA events)."""
    out: Dict[str, Dict[str, Optional[float]]] = {}
    for s in spans():
        row = out.setdefault(s["name"], {"count": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                                         "device_ms": None, "device_self_ms": None})
        row["count"] += 1
        row["host_ms"] += s["host_ms"]
        row["host_self_ms"] += s["host_self_ms"]
        if s["device_ms"] is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + s["device_ms"]
            row["device_self_ms"] = (row["device_self_ms"] or 0.0) + s["device_self_ms"]
    return out


def counters() -> Dict[str, int]:
    """Each counter's total since the last ``reset()``."""
    return dict(_RECORDER.counters)


def dropped() -> int:
    """Spans left unrecorded since the last ``reset()``: past ``MAX_RECORDS``."""
    return _RECORDER.dropped


def reset() -> None:
    """Forget every recorded span and counter."""
    _RECORDER.records = []
    _RECORDER.counters = {}
    _RECORDER.dropped = 0


class StageTimer:
    """Per-stage time, totals and counts by name. Host wall clock by
    default; with a CUDA ``device`` each stage is timed by CUDA events
    around it, on the card's clock (the stage's end is waited for)."""

    def __init__(self, device: DeviceLike = None) -> None:
        self.device: Optional[torch.device] = None if device is None else torch.device(device)
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        on_card = self.device is not None and self.device.type == "cuda"
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if on_card:
                end.record()
                end.synchronize()
                dt = start.elapsed_time(end) / 1e3
            else:
                dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1000.0 * self.totals[k] / self.counts[k],
            }
            for k in self.totals
        }

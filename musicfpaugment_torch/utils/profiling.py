"""Tracing and stage timing (port of musicfpaugment_tpu/utils/profiling.py):
``torch.profiler`` traces in place of ``jax.profiler``'s, NVTX ranges on the
card, and stage timers on the card's clock when they are given a CUDA
device."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch

from musicfpaugment_torch.device import DeviceLike


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


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a trace, and an NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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

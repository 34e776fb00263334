"""What every cell of the benchmark shares: the manifest, the cell's
configuration and traffic, the set-up clock, the measured window, the
device's record, the per-layer readers, the trace and the result line.

A cell is found by name in ``BENCHMARK.json``; its configuration is the JSON
file the manifest names, its traffic ``traffic/<name>.json``, the traffic's
``driver`` names ``drivers/<driver>.py`` and each per-layer metric is read by
``metrics/<metric name>.py``. A later cell, traffic mix or metric is new
files and entries, never an edit here.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(REPO, "BENCHMARK.json")
# the benchmark's own inputs, made once in a checkout (``cached``)
CACHE_DIR = os.path.join(REPO, "portbench_cache")
# whole top-level module names that no run may hold once its window closes
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "musicfpaugment_tpu")

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def load_manifest(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def find(entries: Sequence[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r} in BENCHMARK.json")


def read_json(rel: str) -> dict:
    with open(os.path.join(REPO, rel)) as f:
        return json.load(f)


def load_file_module(path: str, name: str):
    """A module from a file whose name is not an identifier (a metric's
    name holds dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"portbench: cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seeds(seed: int, names: Sequence[str]) -> Dict[str, int]:
    """One 31-bit seed for each purpose, a pure function of the run's seed
    (any size) and the purpose's place in ``names``."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(names), np.uint32)
    return {n: int(w) & 0x7FFFFFFF for n, w in zip(names, words)}


def code_digest() -> str:
    """A digest of the code that makes the benchmark's inputs: ``inputs.py``
    and every file of the frozen ``ref/``."""
    h = hashlib.sha256()
    files = [os.path.join(BENCH_DIR, "inputs.py")]
    for root, dirs, names in os.walk(os.path.join(BENCH_DIR, "ref")):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    for path in files:
        h.update(os.path.relpath(path, BENCH_DIR).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def cached(kind: str, params: dict, build: Callable[[], Dict[str, Any]], device: str
           ) -> Dict[str, Any]:
    """``build()``'s tensors, made once and kept in ``CACHE_DIR`` under a key
    of ``params`` and :func:`code_digest`; later runs in the checkout load
    them onto ``device``."""
    import torch

    key = hashlib.sha256((json.dumps(params, sort_keys=True) + code_digest()).encode())
    path = os.path.join(CACHE_DIR, f"{kind}-{key.hexdigest()[:20]}.pt")
    if os.path.exists(path):
        data = torch.load(path, map_location="cpu", weights_only=True)
        print(f"portbench: {kind} loaded from {os.path.relpath(path, REPO)}",
              file=sys.stderr, flush=True)
        return {k: v.to(device) for k, v in data.items()}
    data = build()
    os.makedirs(CACHE_DIR, exist_ok=True)
    part = path + ".part"
    torch.save({k: v.cpu() for k, v in data.items()}, part)
    os.replace(part, path)
    print(f"portbench: {kind} made and kept in {os.path.relpath(path, REPO)}",
          file=sys.stderr, flush=True)
    return data


def percentile(values: Sequence[float], pct: float) -> float:
    """The ``pct`` percentile of all values, linear between order
    statistics."""
    return float(np.percentile(np.asarray(values, np.float64), pct))


class Check:
    """One number compared with its limit: ``ok`` when ``value <= limit``."""

    def __init__(self, name: str, value: float, limit: float) -> None:
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit

    def as_json(self) -> dict:
        return {"value": self.value, "limit": self.limit}


class Run:
    """One run of one cell: what the driver reads and what it reports."""

    def __init__(self, manifest: dict, workload: str, seed: int, seconds: float,
                 trace: bool, device: str, t0: float,
                 overrides: Optional[dict] = None) -> None:
        self.manifest = manifest
        self.cell = find(manifest["workloads"], workload, "workload")
        cfg_entry = find(manifest["configs"], self.cell["config"], "config")
        self.config = read_json(cfg_entry["file"])
        self.traffic = read_json(os.path.join("portbench", "traffic", self.cell["traffic"] + ".json"))
        # a test's small sizes, over the files' own
        for key, value in (overrides or {}).get("config", {}).items():
            self.config[key] = value
        for key, value in (overrides or {}).get("traffic", {}).items():
            self.traffic[key] = value
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t0 = t0
        self.setup_parts: Dict[str, float] = {}
        self.setup_s: Optional[float] = None
        self.layer: Dict[str, Any] = {}  # what the per-layer readers read

    # ------------------------------------------------------------ set-up

    @contextmanager
    def part(self, name: str):
        """A named part of the set-up, timed and printed on standard error."""
        t = time.perf_counter()
        yield
        self.sync()
        dt = time.perf_counter() - t
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + dt
        print(f"portbench: setup {name} {dt:.3f} s", file=sys.stderr, flush=True)

    def end_setup(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t0
        print(f"portbench: setup_s {self.setup_s:.3f} parts "
              f"{json.dumps({k: round(v, 3) for k, v in self.setup_parts.items()})}",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    # ------------------------------------------------------------ window

    def window(self, step: Callable[[int], Any], min_calls: int = 1
               ) -> Tuple[List[float], float, list]:
        """Whole calls of ``step(i)`` until ``seconds`` have passed and at
        least ``min_calls`` were made, each ending with its results on the
        host. Returns (each call's seconds, the time from the window's
        start to the end of the last call, each call's return value)."""
        times, outs = [], []
        start = time.perf_counter()
        i = 0
        while True:
            t = time.perf_counter()
            outs.append(step(i))
            end = time.perf_counter()
            times.append(end - t)
            i += 1
            if end - start >= self.seconds and i >= min_calls:
                return times, end - start, outs

    # ------------------------------------------------------------ device

    def device_record(self) -> dict:
        import torch

        if not self.device.startswith("cuda"):
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        return {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
        }


# ---------------------------------------------------------------- the trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(run: Run, body: Callable[[], Any]) -> dict:
    """``body()`` under ``torch.profiler`` (host and device activity):
    the device's intervals, the host ops', the traced window on the host's
    clock and the seconds in which some operation ran on the device."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile as tprofile

    run.sync()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        body()
        run.sync()
        window_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        rec = (float(e["ts"]), float(e["dur"]), str(e.get("name", "")))
        if e.get("cat") in DEVICE_CATS:
            dev.append(rec)
        elif e.get("cat") in ("cpu_op", "python_function", "user_annotation", "cuda_runtime"):
            host.append(rec)
    dev.sort()
    busy_us, span = _union(dev)
    return {"device": dev, "host": host, "window_s": window_s,
            "busy_s": busy_us / 1e6, "device_span_s": span / 1e6}


def _union(intervals: List[Tuple[float, float, str]]) -> Tuple[float, float]:
    """(the length of the union of the sorted intervals, their span), us."""
    if not intervals:
        return 0.0, 0.0
    total, cur_s, cur_e = 0.0, intervals[0][0], intervals[0][0] + intervals[0][1]
    for s, d, _ in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    total += cur_e - cur_s
    return total, cur_e - intervals[0][0]


def breakdown(trace: dict, n: int = 10) -> dict:
    """The device operations that took most time (by name) and the longest
    idle gaps of the device, each named by the innermost host op running
    at the gap's middle."""
    by_name: Dict[str, float] = {}
    for _, d, name in trace["device"]:
        by_name[name[:96]] = by_name.get(name[:96], 0.0) + d / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    gaps = []
    end = None
    for s, d, _ in trace["device"]:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = s + d if end is None else max(end, s + d)
    gaps.sort(reverse=True)
    host = trace["host"]
    named = []
    for length, g0, g1 in gaps[:n]:
        mid = (g0 + g1) / 2
        inner, before = None, None
        for s, d, name in host:
            if s <= mid <= s + d and (inner is None or s > inner[0]):
                inner = (s, name)
            elif s + d < mid and (before is None or s + d > before[0]):
                before = (s + d, name)
        label = inner[1] if inner else ("host, after " + before[1]) if before else "host"
        named.append([label[:96], length / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def device_seconds(trace: dict, match: Callable[[str], bool]) -> Tuple[float, int]:
    """(summed device seconds, count) of the device events whose name
    matches."""
    sel = [d for _, d, name in trace["device"] if match(name)]
    return sum(sel) / 1e6, len(sel)


# ---------------------------------------------------------------- readers

def per_layer_metrics(run: Run, reported_e2e: Sequence[str]) -> List[dict]:
    """The manifest's per-layer metrics that this cell reports: those whose
    ``workloads`` name it, or that list none and move an end-to-end metric
    it reports."""
    out = []
    for m in run.manifest["per_layer"]:
        if "workloads" in m:
            if run.cell["name"] in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported_e2e:
            out.append(m)
    return out


def read_layers(run: Run, metrics: Sequence[dict]) -> Dict[str, dict]:
    """Each metric's reader, ``metrics/<name>.py``'s ``read(run)``; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        path = os.path.join(BENCH_DIR, "metrics", m["name"] + ".py")
        reader = load_file_module(path, "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is None:
            print(f"portbench: {m['name']}: nothing to read", file=sys.stderr, flush=True)
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))

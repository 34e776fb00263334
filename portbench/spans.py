"""What the readers of the program's own spans and counters share.

The program records its spans and counters while a profile is active
(``musicfpaugment_torch.utils.profiling``: ``annotate``, ``count``,
``spans()``), so the profiled slice of a ``--trace 1`` run holds them. The
slice's spans are the last of the program's root spans, as many as the
trace holds events of that name, and everything under them; a reader
divides by the number of those roots (batches or steps). Each span is also
a ``user_annotation`` event in the trace, on the device's clock: the
device's idle time is put down to the innermost span open over it. Every
reader returns None where the program recorded nothing for it (a program
without the spans, a span it does not open), and a device-time reader also
on a CPU run.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence, Tuple


def _profiling():
    """The program's span module, or None where it keeps no spans."""
    try:
        from musicfpaugment_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def slice_spans(run, root: str) -> Optional[Tuple[List[dict], int]]:
    """(the closed spans under the slice's ``root`` spans, their number), or
    None where the slice holds no such root or the program kept fewer."""
    trace = run.layer.get("trace")
    profiling = _profiling()
    if not trace or profiling is None:
        return None
    n = sum(1 for _, _, name in trace["host"] if name == root)
    if n == 0:
        return None
    recs = profiling.spans()
    roots = [r for r in recs if r["name"] == root and r["parent"] is None][-n:]
    if len(roots) < n:
        return None
    ids = {r["id"] for r in roots}
    return [r for r in recs if r["root"] in ids], n


def per_root(run, root: str, names: Sequence[str], field: str) -> Optional[float]:
    """The summed ``field`` of the slice's spans named in ``names``, per
    root span. A ``device_*`` field reads nothing off the card."""
    if field.startswith("device") and not run.device.startswith("cuda"):
        return None
    got = slice_spans(run, root)
    if got is None:
        return None
    recs, n = got
    values = [r[field] for r in recs if r["name"] in names]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / n


def counter(run, root: str, name: str, per: Optional[str] = None) -> Optional[float]:
    """The counter ``name`` over the slice's spans, per root span or, with
    ``per``, per span of that name."""
    got = slice_spans(run, root)
    if got is None:
        return None
    recs, n = got
    counted = [r["counts"][name] for r in recs if name in r["counts"]]
    if not counted:
        return None
    if per is not None:
        n = sum(1 for r in recs if r["name"] == per)
        if n == 0:
            return None
    return sum(counted) / n


def _busy(device: List[Tuple[float, float, str]]) -> List[Tuple[float, float]]:
    """The union of the device's sorted intervals, as (start, end) us."""
    out: List[Tuple[float, float]] = []
    for s, d, _ in device:
        if out and s <= out[-1][1]:
            if s + d > out[-1][1]:
                out[-1] = (out[-1][0], s + d)
        else:
            out.append((s, s + d))
    return out


def _innermost(spans: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The timeline of the innermost open span: (start, end, name) pieces
    between consecutive span boundaries, the latest-opened span winning."""
    bounds = sorted({t for s, e, _ in spans for t in (s, e)})
    order = sorted(spans)
    out, open_, k = [], [], 0
    for t0, t1 in zip(bounds, bounds[1:]):
        while k < len(order) and order[k][0] <= t0:
            open_.append(order[k])
            k += 1
        open_ = [sp for sp in open_ if sp[1] > t0]
        if open_:
            out.append((t0, t1, max(open_, key=lambda sp: (sp[0], -sp[1]))[2]))
    return out


def idle_by_span(run, root: str) -> Optional[Dict[Optional[str], float]]:
    """Seconds of the slice's device-idle time by the innermost program
    span open over them (None: outside every span). The slice runs from
    the first root span or device operation to the last; the spans are
    the trace's ``user_annotation`` events whose names the program
    recorded."""
    trace = run.layer.get("trace")
    got = slice_spans(run, root)
    if got is None or not trace["device"]:
        return None
    names = {r["name"] for r in got[0]}
    spans = [(s, s + d, name) for s, d, name in trace["host"] if name in names]
    roots = [sp for sp in spans if sp[2] == root]
    busy = _busy(trace["device"])
    lo = min(roots[0][0], busy[0][0])
    hi = max(max(sp[1] for sp in roots), busy[-1][1])
    idle, t = [], lo
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if hi > t:
        idle.append((t, hi))
    pieces = _innermost(spans)
    out: Dict[Optional[str], float] = {}
    k = 0
    for g0, g1 in idle:
        covered = 0.0
        while k < len(pieces) and pieces[k][1] <= g0:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < g1:
            s, e, name = pieces[j]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                out[name] = out.get(name, 0.0) + part / 1e6
                covered += part
            j += 1
        out[None] = out.get(None, 0.0) + (g1 - g0 - covered) / 1e6
    return out


def idle_share(run, root: str, names: Sequence[str]) -> Optional[float]:
    """The share of the slice's device-idle time during which one of
    ``names`` is the innermost open span, in %. Prints the whole split and
    the root spans' device seconds against the slice on standard error."""
    by = idle_by_span(run, root)
    if by is None:
        return None
    total = sum(by.values())
    if total <= 0:
        return None
    recs, n = slice_spans(run, root)
    roots_ms = [r["device_ms"] for r in recs if r["parent"] is None]
    roots_s = sum(roots_ms) / 1e3 if roots_ms and None not in roots_ms else None
    split = {str(k): round(v, 6) for k, v in sorted(by.items(), key=lambda kv: -kv[1])}
    print(f"portbench: {n} {root} spans; device idle {total:.6f} s by innermost span {split}; "
          f"root spans' device s {roots_s} of window_s {run.layer['trace']['window_s']:.6f}",
          file=sys.stderr, flush=True)
    return 100.0 * sum(by.get(name, 0.0) for name in names) / total

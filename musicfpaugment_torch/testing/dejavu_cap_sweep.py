"""Dejavu's hot-key row cap against accuracy, rate and index size (port of
examples/dejavu_cap_sweep.py).

``DejavuDeviceIndex.max_rows_per_hash`` cuts each hot hash bucket to the
``cap`` rows of the smallest song ids, where the original's SQL fetch is
unbounded. This sweep measures what the cut costs: one raw index of the
storage-free corpus (``testing/dejavu_scale``'s, same seed, same tracks),
ingested with no cap, re-finalized under each cap, and the same queries
through the batched matcher under each.

Stages (state in ``--workdir``, shared with ``dejavu_scale``'s layout):

  ingest - ``dejavu_scale``'s ingest at ``--tracks`` with the ingest-time
           cap at 2^31 - 1 (keep every row), resumable and bounded by
           ``--minutes``;
  sweep  - for each of ``--caps``: ``finalize`` under that cap, the upload,
           then ``--queries`` crops of each of ``--conditions``: per cap
           ``bucket_depth``, ``rows_stored``, ``rows_dropped(_pct)``,
           ``index_mb``, ``finalize_s``, ``upload_s`` and per condition
           ``accuracy`` and ``match_qps``. Writes ``--out`` (default
           ``<workdir>/dejavu_cap_sweep.json``).

Run on the card:
  python -m musicfpaugment_torch.testing.dejavu_cap_sweep ingest --tracks 10000
  python -m musicfpaugment_torch.testing.dejavu_cap_sweep sweep --caps 64,256,1024,inf \\
      --queries 512 --conditions cleans,default_parameters,bn_m10,full_hard
Every stage runs on CUDA and raises without it unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

from musicfpaugment_torch.afp.dejavu import DejavuDeviceIndex, DejavuDeviceMatcher
from musicfpaugment_torch.device import resolve_device
from musicfpaugment_torch.testing import dejavu_scale as ds
from musicfpaugment_torch.testing.scale_proof import (
    Tracks,
    condition_augmenter,
    condition_batches,
    corpus_tracks,
    default_workdir,
    load_state,
    make_queries,
    query_plan,
    require_ingest,
    save_state,
    select_conditions,
    sync,
)

NO_CAP = (1 << 31) - 1


def parse_cap(cap: str) -> int:
    return NO_CAP if cap == "inf" else int(cap)


def refinalize(idx: DejavuDeviceIndex, cap: int):
    """The index's CSR under ``cap`` rows a key, from its raw rows."""
    idx.max_rows_per_hash = cap
    idx._frozen = None
    return idx.finalize()


def sweep_cap(args, idx: DejavuDeviceIndex, cap_str: str, tracks: Tracks, qidx, offsets,
              conditions: dict, total_rows: int) -> dict:
    """One cap: finalize, upload, every condition's queries."""
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    starts, rows, _nb, depth = refinalize(idx, parse_cap(cap_str))
    finalize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dm = DejavuDeviceMatcher(idx, device=dev)
    sync(dev)
    upload_s = time.perf_counter() - t0
    entry = {
        "cap": cap_str if cap_str == "inf" else int(cap_str),
        "bucket_depth": int(depth),
        "rows_stored": int(rows.size),
        "rows_dropped": int(idx.rows_dropped),
        "rows_dropped_pct": round(100.0 * idx.rows_dropped / max(total_rows, 1), 2),
        "index_mb": round((rows.nbytes + starts.nbytes) / 1e6, 1),
        "finalize_s": round(finalize_s, 2),
        "upload_s": round(upload_s, 2),
        "conditions": {},
    }
    dm.match_waveforms(make_queries(tracks, qidx[: args.batch], offsets[: args.batch]))
    for cond, params in conditions.items():
        fp = condition_augmenter(params, args) if params is not None else None
        correct = n_done = 0
        match_s = 0.0
        for _, tids, crops in condition_batches(tracks, fp, qidx, offsets, args.batch):
            sync(dev)
            t0 = time.perf_counter()
            res = dm.match_waveforms(crops)
            match_s += time.perf_counter() - t0
            correct += sum(ds.is_hit(r, tid) for r, tid in zip(res, tids))
            n_done += len(tids)
        entry["conditions"][cond] = {
            "accuracy": round(correct / max(n_done, 1), 4),
            "match_qps": round(n_done / match_s, 1),
        }
        print(f"cap={cap_str} {cond} {entry['conditions'][cond]}", flush=True)
    return entry


def stage_sweep(args) -> dict:
    """Every cap of ``--caps`` not swept yet (all with ``--rerun``); the
    JSON at ``--out``."""
    dev = resolve_device(args.device)
    state = load_state(args.workdir)
    require_ingest(state)
    idx = ds.load_index(args.workdir)
    total_rows = int(sum(idx.total_hashes))
    tracks = corpus_tracks(args.corpus_seed, dev)
    qidx, offsets = query_plan(state["tracks_target"], args.queries, 42)
    conditions = select_conditions(args.conditions)
    sweep = state.get("cap_sweep", {})
    for cap_str in args.caps.split(","):
        if cap_str in sweep and not args.rerun:
            continue
        sweep[cap_str] = sweep_cap(args, idx, cap_str, tracks, qidx, offsets, conditions, total_rows)
        state["cap_sweep"] = sweep
        state["sweep_queries"] = args.queries
        save_state(args.workdir, state)
    report = {
        "tracks": state["tracks_target"],
        "queries": args.queries,
        "total_rows_ingested": total_rows,
        "caps": sweep,
    }
    out = args.out or os.path.join(args.workdir, "dejavu_cap_sweep.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print("wrote", out)
    return report


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("stage", choices=["ingest", "sweep"])
    p.add_argument("--workdir", default=default_workdir("dejavu_cap_sweep"))
    p.add_argument("--out", default=None, help="sweep file (default <workdir>/dejavu_cap_sweep.json)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tracks", type=int, default=10000)
    p.add_argument("--queries", type=int, default=512)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--minutes", type=float, default=8.0)
    p.add_argument("--caps", default="64,256,1024,inf")
    p.add_argument("--conditions", default="cleans,default_parameters,bn_m10,full_hard")
    p.add_argument("--corpus-seed", type=int, default=1234)
    p.add_argument("--hash-cap", type=int, default=NO_CAP,
                   help="ingest-time cap: keep every row so that the sweep can "
                        "re-finalize the same raw index under any cap")
    p.add_argument("--banks", choices=["toy", "dcase"], default="toy")
    p.add_argument("--bank-hours", type=float, default=2.0)
    p.add_argument("--rerun", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser().parse_args(argv)
    resolve_device(args.device)  # CUDA unless --device cpu; raises without it
    dict(ingest=ds.stage_ingest, sweep=stage_sweep)[args.stage](args)


if __name__ == "__main__":
    main()

"""The undenoised reference-scale tables of both systems in one process:
``scale_proof`` ingest and match, then ``dejavu_scale`` ingest and match
(the README's stage order; no denoiser, oracle or peaks stage), and the
comparison of their reports with the JAX package's.

    python -m musicfpaugment_torch.testing.scale_tables --queries 10000 \\
        --workdir scale_work --out tables_out

Writes ``results.json`` and ``dejavu_results.json`` (the stages' reports)
and ``comparison.json`` under ``--out``: the table statistics
(``total_hashes``, ``max_bucket_count``, ``reservoir_dropped_pct``,
``buckets_at_depth``; Dejavu's ``total_rows`` and ``bucket_depth``) and the
accuracy of each condition beside the values in ``--jax-results`` and
``--jax-dejavu-results``. Dejavu's index is finalized once and its CSR
shared by the match stage. CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

from musicfpaugment_torch.device import resolve_device
from musicfpaugment_torch.testing import dejavu_scale as ds
from musicfpaugment_torch.testing import scale_proof as sp

TABLE_KEYS = ("total_hashes", "stored_hashes", "max_bucket_count", "reservoir_dropped_pct",
              "buckets_at_depth", "buckets_over_depth")
DEJAVU_KEYS = ("total_rows", "total_rows_stored", "bucket_depth", "rows_dropped")


def compare(port: dict, jax: Optional[dict], keys: Sequence[str]) -> dict:
    """Each statistic and each condition's accuracy, port beside JAX."""
    jax = jax or {}
    out = {k: {"port": port.get(k), "jax": jax.get(k)} for k in keys}
    out["accuracy"] = {
        c: {"port": row.get("accuracy"), "jax": jax.get("conditions", {}).get(c, {}).get("accuracy")}
        for c, row in port.get("conditions", {}).items()
    }
    return out


def _load(path: Optional[str]) -> Optional[dict]:
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def run(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=sp.default_workdir("scale_tables"))
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tracks", type=int, default=106574)
    p.add_argument("--queries", type=int, default=10000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--shifts", type=int, default=4)
    p.add_argument("--banks", choices=["toy", "dcase"], default="dcase")
    p.add_argument("--conditions", default="all")
    p.add_argument("--jax-results", default="examples/scale_out/results.json")
    p.add_argument("--jax-dejavu-results", default="examples/scale_out/dejavu_results.json")
    args = p.parse_args(argv)
    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    common = ["--device", args.device, "--tracks", str(args.tracks), "--batch", str(args.batch)]
    seconds = {}

    def stage(name, module, stage_name, *flags, **kw):
        a = module.parser().parse_args(
            [stage_name, "--workdir", os.path.join(args.workdir, module.__name__.rsplit(".", 1)[1]),
             *common, *flags])
        t0 = time.perf_counter()
        module_stage = getattr(module, f"stage_{stage_name}")
        module_stage(a, **kw)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return a

    match = ["--queries", str(args.queries), "--banks", args.banks, "--conditions", args.conditions]
    stage("audfprint_ingest", sp, "ingest", "--minutes", "600")
    a = stage("audfprint_match", sp, "match", "--shifts", str(args.shifts), *match)
    port = sp.write_report(a.workdir, os.path.join(args.out, "results.json"), "results.json")
    a = stage("dejavu_ingest", ds, "ingest", "--minutes", "600")
    t0 = time.perf_counter()
    index = ds.load_index(a.workdir)
    index.finalize()
    seconds["dejavu_finalize"] = round(time.perf_counter() - t0, 1)
    a = stage("dejavu_match", ds, "match", *match, index=index)
    port_dj = sp.write_report(a.workdir, os.path.join(args.out, "dejavu_results.json"),
                              "dejavu_results.json")
    out = {
        "tracks": args.tracks, "queries": args.queries, "shifts": args.shifts, "banks": args.banks,
        "seconds": seconds,
        "audfprint": compare(port, _load(args.jax_results), TABLE_KEYS),
        "dejavu": compare(port_dj, _load(args.jax_dejavu_results), DEJAVU_KEYS),
    }
    with open(os.path.join(args.out, "comparison.json"), "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    run()

"""Small sizes for running whole cells on the CPU in the tests: a few short
tracks, a shallow 2^20-bucket table, small banks and narrow models (each
kind's ``TINY_ARGS``). The files' own sizes are the card's."""

from __future__ import annotations

import contextlib
import copy
import io
import json
import time

BANKS = {"hours": 0.005, "num_irs": 4, "num_scenes": 2}

IDENTIFY = {
    "config": {"tracks": 24, "track_seconds": 10,
               "hashtable": {"hashbits": 20, "depth": 4, "maxtime": 16384}},
    "traffic": {"pool": 16, "batch": 8, "ingest_batch": 8, "sample_batches": 2, "sample_queries": 4,
                "augment_batch": 8, "banks": BANKS, "trace_batches": 1,
                "trace_min_seconds": 0.0},
}
TRAIN = {
    "config": {"track_seconds": 4},
    "traffic": {"batch": 4, "batches": 5, "tracks": 8, "clip_seconds": 2, "trace_steps": 1,
                "trace_min_seconds": 0.0, "banks": BANKS},
}


def overrides(cell: str) -> dict:
    """The small sizes of ``cell``: its traffic's driver's, and its
    configuration's kind's ``TINY_ARGS``."""
    from portbench import harness as H
    from portbench import inputs as I

    manifest = H.load_manifest()
    w = H.find(manifest["workloads"], cell, "workload")
    cfg = H.read_json(H.find(manifest["configs"], w["config"], "config")["file"])
    traffic = H.read_json(f"portbench/traffic/{w['traffic']}.json")
    ov = copy.deepcopy(TRAIN if traffic["driver"] == "train" else IDENTIFY)
    ov["config"]["model_args"] = dict(I.kind(cfg).TINY_ARGS)
    return ov


def run_cell(cell: str, seed: int = 3_000_000_001, seconds: float = 0.5, trace: int = 0):
    """(exit code, the result line or None, standard error) of one run of
    ``cell`` on the CPU at the small sizes."""
    from portbench import run as R

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = R.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                     "--trace", str(trace)], device="cpu", overrides=overrides(cell),
                    t0=time.perf_counter())
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()

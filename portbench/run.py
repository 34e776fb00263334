"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (a profiled slice follows the
window). The last line of standard output is one JSON object; the numbers
that decide ``correct`` end it, under ``checks``, and are the last lines of
standard error. Exits non-zero, printing no result, without enough CUDA
devices, or if JAX or the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()  # the set-up's clock starts before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness as H  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, overrides=None, t0=None) -> int:
    """``device`` and ``overrides`` are for the CPU tests alone: a run from
    the command line takes the card and the files' own sizes."""
    args = parse(argv)
    manifest = H.load_manifest()
    cell = H.find(manifest["workloads"], args.workload, "workload")
    if device is None:
        import torch

        if not torch.cuda.is_available():
            print("portbench: CUDA is not available", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {cell['name']} needs {cell['chips']} CUDA devices, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = "cuda"
    run = H.Run(manifest, args.workload, args.seed, args.seconds, bool(args.trace), device,
                T0 if t0 is None else t0, overrides)
    driver = H.load_file_module(
        os.path.join(H.BENCH_DIR, "drivers", run.traffic["driver"] + ".py"),
        "portbench_driver_" + run.traffic["driver"])
    out = driver.run(run)
    loaded = H.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    measured = dict(out["measured"], setup_s=run.setup_s)
    if run.trace:
        metrics = H.read_layers(run, H.per_layer_metrics(run, [m["name"] for m in e2e]))
    else:
        # a driver measures by base name; ``identify_qps.unet`` is ``identify_qps``
        # in the cells that metric lists
        metrics = {m["name"]: {"value": float(measured[m["name"].split(".")[0]]),
                               "unit": m["unit"]} for m in e2e}
    checks = out["checks"]
    correct = all(c.ok for c in checks) and out["failed"] == 0
    device_rec = dict(out["device"])
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": device_rec}
    if run.trace:
        trace = run.layer["trace"]
        device_rec["busy_s"] = trace["busy_s"]
        device_rec["window_s"] = trace["window_s"]
        line["breakdown"] = H.breakdown(trace)
    line["checks"] = {c.name: c.as_json() for c in checks}
    for c in checks:
        print(f"portbench: check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

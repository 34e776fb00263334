"""The readings that a cell's limits are set from, on the card at the cell's
own size, several seeds in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 [--out FILE]

For each seed: the cell's set-up, its recorded batches or judged steps run
as a run runs them, and then

- ``sound``: the program against the plain reference (what a run
  compares);
- ``control``: the reference at the precision below the configuration's
  (TF32 in cuDNN for a model, bfloat16 spectrograms without one) in the
  program's place, against the reference;
- for a training cell, ``half_batch``: the reference with the loss taken
  over half of each batch, in the program's place.

A state left unchanged reads 1 on the change of every leaf and needs no
run. The benchmark's own runs do not run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import harness as H  # noqa: E402
from portbench.judge import identify as JI  # noqa: E402
from portbench.judge import train as JT  # noqa: E402


def identify_readings(run: H.Run, control: str) -> dict:
    D = H.load_file_module(os.path.join(H.BENCH_DIR, "drivers", "identify.py"), "pb_identify")
    st = D.setup(run)
    step = D.batch_step(run, st)
    step(-1)
    for i in range(max(st["rec_batches"]) + 1):
        step(i)
    waves, prog, table, sample_tracks = D.sample(run, st)
    sound = D.reference_numbers(run, waves, prog, table, "strict")
    sound["table_entries"] = D.table_numbers(run, st, prog, table, sample_tracks)
    hook = None
    cfg = run.config
    if "denoised" in prog:
        weights = JI.I.denoiser_weights(cfg, st["seeds"]["weights"], run.device)
        _, hook = JI.reference_denoiser(cfg, run.device, weights)
    low = {arm: JI.reference_outputs(cfg, waves, arm, hook, table, control) for arm in prog}
    return {"sound": sound, "control": D.reference_numbers(run, waves, low, table, "strict")}


def train_readings(run: H.Run) -> dict:
    D = H.load_file_module(os.path.join(H.BENCH_DIR, "drivers", "train.py"), "pb_train")
    st = D.setup(run)
    n = run.traffic["judged_steps"]
    record = JT.record_steps(st["trainer"], st["batches"][:n])
    st.pop("trainer")
    st.pop("checkpoint").cleanup()
    torch.cuda.empty_cache()
    args = (run.config, run.traffic, st["seeds"], st["banks"], st["batches"][:n], run.device)
    strict = JT.reference_steps(*args, "strict")
    return {"sound": JT.compare(record, strict),
            "control": JT.compare(JT.reference_steps(*args, "tf32"), strict),
            "half_batch": JT.compare(JT.reference_steps(*args, "strict", "half_batch"), strict)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    manifest = H.load_manifest()
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = H.Run(manifest, args.workload, seed, 0.0, False, "cuda", t)
        if run.traffic["driver"] == "train":
            readings = train_readings(run)
        else:
            control = "tf32" if "denoised" in run.traffic["arms"] else "bf16_spectrogram"
            readings = identify_readings(run, control)
        line = {"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t,
                **readings}
        print(json.dumps(line), flush=True)
        lines.append(line)
        del run
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

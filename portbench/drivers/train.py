"""Training steps of the program's ``Trainer``, back to back, as an epoch
runs them.

Set-up: the first tracks of the corpus made on the device by the frozen
generator, distinct clean crops of them in batches (on the host, as a
loader hands them over), the frozen augmenter's banks handed to the
program's ``AugmentFP`` under the traffic's condition (the banks are the
traffic's content, the same on every seed), the configuration's
model with seeded weights loaded into the ``Trainer`` after it is built.
The first ``judged_steps`` steps run in set-up through ``train_step`` on
their own batches and are recorded (each step's loss, the augmented
batches, Adam's first moments after the first step, the parameters before
the first and after the last); the same trainer then runs the window.
After the window the plain reference (``judge/train.py``) follows those
steps from the same weights, batches and keys.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import List

import numpy as np
import torch

from portbench import harness as H
from portbench import inputs as I
from portbench.judge import train as J

SEED_PARTS = ("corpus", "crops", "weights", "trainer")
# the one kind the trainer's spectrogram input and ``judge/train.py`` run
KIND = "unet"


def setup(run: H.Run) -> dict:
    cfg, tr, dev = run.config, run.traffic, run.device
    if cfg["model"] != KIND:
        raise SystemExit(f"portbench: the train driver runs the {KIND} kind only, "
                         f"not {cfg['model']!r} (configuration {run.cell['config']!r})")
    seeds = H.sub_seeds(run.seed, SEED_PARTS)
    with run.part("import"):
        from musicfpaugment_torch.augment.banks import IRBank, NoiseBank
        from musicfpaugment_torch.augment.pipeline import AugmentFP
        from musicfpaugment_torch.train.trainer import Trainer
    if dev.startswith("cuda"):
        with run.part("build"):
            from musicfpaugment_torch import _build

            _build.library()
    sr = cfg["audfprint"]["samplerate"]
    track_len = cfg["track_seconds"] * sr
    clip = tr["clip_seconds"] * sr
    B, n_batches = tr["batch"], tr["batches"]
    with run.part("corpus"):
        ids, offs = I.crop_plan(seeds["crops"], B * n_batches, tr["tracks"], track_len, clip)
        clean = torch.empty(B * n_batches, clip, device=dev)
        waves = I.tracks(seeds["corpus"], range(tr["tracks"]), track_len, sr, dev)
        I.crops_from(waves, np.arange(tr["tracks"]), ids, offs, clip, clean)
        del waves
        batches = list(clean.cpu().split(B))
        del clean
    with run.part("banks"):
        noise, irs = I.banks(I.content_seeds(tr)["banks"], sr, dev, **tr.get("banks", {}))
        cond = H.read_json(os.path.join("portbench", "traffic", "conditions",
                                        tr["condition"] + ".json"))
        aug = AugmentFP(
            NoiseBank(noise.clips.clone(), noise.scene_starts.clone(), noise.scene_counts.clone(),
                      noise.sample_rate),
            sr, parameters=cond,
            impulse_response_dir=IRBank(irs.irs.clone(), irs.lengths.clone(), irs.sample_rate),
            device=dev)
    with run.part("weights"):
        model = I.program_model(cfg)
        # the trainer makes its checkpoint directory; it saves nothing there
        ckpt = tempfile.TemporaryDirectory()
        trainer = Trainer(model, iter(()), 1, iter(()), 1, learning_rate=tr["lr"],
                          nb_epochs=1, checkpoint=ckpt.name, input_type="spec",
                          augmenter=aug, seed=seeds["trainer"], device=dev)
        # the benchmark's weights, not the trainer's own initialisation
        trainer.model.load_state_dict(I.weights(cfg, seeds["weights"], dev))
    return {"seeds": seeds, "trainer": trainer, "batches": batches, "banks": (noise, irs),
            "checkpoint": ckpt}


def run(run: H.Run) -> dict:
    st = setup(run)
    trainer, batches, tr = st["trainer"], st["batches"], run.traffic
    n_judged = tr["judged_steps"]
    with run.part("warmup"):
        record = J.record_steps(trainer, batches[:n_judged])
    run.end_setup()
    nb = len(batches)
    steps = [n_judged]

    def step(i: int):
        k = steps[0]
        steps[0] += 1
        return trainer.train_step(batches[k % nb])

    # whole steps, as an epoch queues them: the host runs ahead of the card
    # and the window closes when the last step's loss is on the host
    start = time.perf_counter()
    losses = []
    while True:
        losses.append(step(0)["loss"])
        if time.perf_counter() - start >= run.seconds:
            break
    last = float(losses[-1])
    elapsed = time.perf_counter() - start
    n = len(losses)
    finite = sum(bool(torch.isfinite(v)) for v in losses)
    print(f"portbench: {n} steps in {elapsed:.3f} s, last loss {last:.6f}",
          file=sys.stderr, flush=True)
    measured = {"train_examples_per_s": n * tr["batch"] / elapsed}
    device = run.device_record()
    if run.trace:
        traced(run, st, step, elapsed, n)
    st.pop("trainer")
    del trainer
    st.pop("checkpoint").cleanup()
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    checks = J.judge(run, st, record, "strict")
    checks.append(H.Check("steps_not_finite", n - finite, 0))
    return {"measured": measured, "attempted": n + n_judged, "failed": n - finite,
            "checks": checks, "device": device}


def traced(run: H.Run, st: dict, step, elapsed: float, n_steps: int) -> None:
    """What the per-layer readers read: the window's FLOPs, the augmenter's
    host time per step (the benchmark's span around the trainer's calls
    into it) and a profiled slice of steady steps with the dropout
    kernel's launches and sizes."""
    cfg, tr = run.config, run.traffic
    sr = cfg["audfprint"]["samplerate"]
    clip = tr["clip_seconds"] * sr
    frames = 1 + clip // cfg["audfprint"]["n_hop"]
    shape = (tr["batch"], cfg["audfprint"]["n_fft"] // 2 + 1, frames)
    run.layer.update({"model_flops": 3 * I.forward_flops(cfg, shape) * n_steps,
                      "window_s": elapsed})
    from musicfpaugment_torch.models import dropout as D

    trainer = st["trainer"]
    aug = trainer.augmenter
    spent = [0.0]

    def spanned(fn):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[0] += time.perf_counter() - t
        return call

    def steady(count):
        t0, done = time.perf_counter(), 0
        while done < tr["trace_steps"] or time.perf_counter() - t0 < tr["trace_min_seconds"]:
            out = step(0)
            done += 1
        float(out["loss"])
        count[0] = done

    # the span first, on steps the profiler does not slow
    aug.draw, aug.apply = spanned(aug.draw), spanned(aug.apply)
    spanned_steps = [0]
    try:
        steady(spanned_steps)
    finally:
        del aug.draw, aug.apply
    sizes: List[int] = []
    orig = D._launch

    def launch(x, *args, **kw):
        sizes.append(x.numel())
        return orig(x, *args, **kw)

    D._launch = launch
    before = D.LAUNCHES["dropout_threefry"]
    k = [0]
    try:
        trace = H.profile(run, lambda: steady(k))
    finally:
        D._launch = orig
    run.layer.update({
        "trace": trace, "augment_host_s": spent[0], "augment_steps": spanned_steps[0],
        "dropout_launches": D.LAUNCHES["dropout_threefry"] - before,
        "dropout_elements": sizes,
    })

"""Identification of degraded queries through the program's audfprint path.

Set-up: a corpus of 30 s tracks made on the device by the frozen generator
and indexed by the program's ``create_fp_database`` into a full
``HashTable``; the pool of degraded 8 s queries (crops of indexed tracks
under the traffic's condition, through the frozen augmenter and its banks);
the configuration's model with seeded near-identity weights and its hook,
for a ``denoised`` arm. The corpus and the pool are the traffic's content,
the same whatever the run's seed, so every run does the same work: the
pool's batches cycle in their fixed order, and the seed picks the batch the
window starts at, draws the weights' perturbation and the sample that is
judged. Each batch of the window is one call of the program's
``compute_accuracy_batched`` over the pool's rows with the prebuilt
``DeviceMatcher``: ``match_waveforms`` once per arm, the mix rule, the
scores.

A few batches drawn from the seed among the window's first are recorded as
they run (the denoiser's outputs, every shift's masks, the compacted hashes,
the verdicts); after the window a sample of their queries is judged against
the plain reference (``judge/identify.py``).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import harness as H
from portbench import inputs as I
from portbench.judge import identify as J

SEED_PARTS = ("start", "weights", "sample")
# the analyzer's attribute that holds the hook of a kind's ``DOMAIN``
HOOK_ATTR = {"spectrogram": "spec_denoiser", "waveform": "wave_denoiser"}


def setup(run: H.Run) -> dict:
    """Everything before the window; returns the state the window and the
    judge read."""
    cfg, tr, dev = run.config, run.traffic, run.device
    seeds = H.sub_seeds(run.seed, SEED_PARTS)
    content = I.content_seeds(tr)
    with run.part("import"):
        from musicfpaugment_torch.afp.audfprint.analyzer import AudfprintPeaks
        from musicfpaugment_torch.afp.audfprint.hash_table import HashTable
        from musicfpaugment_torch.afp.audfprint.matcher_device import DeviceMatcher
        from musicfpaugment_torch.testing.audfprint_exps import create_fp_database
    if dev.startswith("cuda"):
        with run.part("build"):
            from musicfpaugment_torch import _build

            _build.library()
    s = cfg["audfprint"]
    sr = s["samplerate"]
    n_tracks = cfg["tracks"]
    track_len = cfg["track_seconds"] * sr
    B = tr["batch"]
    if tr["pool"] % B:
        raise SystemExit("portbench: the query pool must be a whole number of batches")
    hcfg = cfg["hashtable"]
    ht = HashTable(hashbits=hcfg["hashbits"], depth=hcfg["depth"], maxtime=hcfg["maxtime"])
    analyzer = AudfprintPeaks(s, device=dev)
    block = tr["ingest_batch"] * 8
    for first in range(0, n_tracks, block):
        idx = list(range(first, min(first + block, n_tracks)))
        with run.part("corpus"):
            waves = I.tracks(content["corpus"], idx, track_len, sr, dev)
        with run.part("ingest"):
            create_fp_database(list(waves), None, analyzer, batch_size=tr["ingest_batch"],
                               hash_tab=ht, names=[f"t{i:06d}" for i in idx], device=dev,
                               num_workers=1)
        del waves
    with run.part("ingest"):
        dm = DeviceMatcher(ht, device=dev)
    print(f"portbench: table eff_depth {dm.eff_depth} of {ht.depth}, largest bucket "
          f"{int(ht.counts.max())}, hashes {int(ht.counts.sum())}", file=sys.stderr, flush=True)
    with run.part("pool"):
        pool, q_ids = I.query_pool(cfg, tr, dev)
    arms = []
    model = None
    for arm in tr["arms"]:
        if arm == "plain":
            arms.append((arm, analyzer))
            continue
        with run.part("weights"):
            model = I.program_model(cfg).to(dev)
            model.load_state_dict(I.denoiser_weights(cfg, seeds["weights"], dev))
            arms.append((arm, I.kind(cfg).program_arm(model, s, dev)))
    n_batches = tr["pool"] // B
    start = int(np.random.default_rng(seeds["start"]).integers(n_batches))
    rng = np.random.default_rng(seeds["sample"])
    rec_batches = sorted(rng.choice(tr["sample_batches"], size=2, replace=False).tolist())
    return {"seeds": seeds, "content": content, "ht": ht, "dm": dm, "pool": pool,
            "q_ids": q_ids, "names": [f"t{int(i):06d}" for i in q_ids], "arms": arms,
            "model": model, "domain": I.kind(cfg).DOMAIN if model is not None else None,
            "B": B, "n_batches": n_batches, "start": start,
            "rec_batches": rec_batches, "records": {}, "rng": rng}


def pool_rows(st: dict, i: int) -> slice:
    """The pool's rows that window call ``i`` matches."""
    j = (st["start"] + i) % st["n_batches"]
    return slice(j * st["B"], (j + 1) * st["B"])


def recorders(st: dict, calls: list):
    """Install recorders for one batch, arm by arm: the denoiser's outputs,
    ``find_peaks_shifts``' masks and ``_compact_hashes``' output of the
    arm whose ``match_waveforms`` is running (the ``calls`` made so far say
    which). Returns the records and the function that removes them."""
    from musicfpaugment_torch.afp.audfprint import matcher_device as MD

    names = [name for name, _ in st["arms"]]
    recs = {name: {"den": [], "masks": None, "hashes": None, "verdicts": []} for name in names}
    dm = st["dm"]
    orig_peaks = MD.find_peaks_shifts
    orig_compact = dm._compact_hashes

    def peaks(*args, **kw):
        out = orig_peaks(*args, **kw)
        recs[names[len(calls)]]["masks"] = [m.clone() for m in out]
        return out

    def compact(*args, **kw):
        out = orig_compact(*args, **kw)
        recs[names[len(calls)]]["hashes"] = tuple(t.clone() for t in out)
        return out

    def kept(fn, rec):
        def call(x):
            out = fn(x)
            rec["den"].append(out.clone())
            return out
        return call

    MD.find_peaks_shifts = peaks
    dm._compact_hashes = compact
    hooks = []
    for name, a in st["arms"]:
        if a.denoising:
            attr = HOOK_ATTR[st["domain"]]
            fn = getattr(a, attr)
            hooks.append((a, attr, fn))
            setattr(a, attr, kept(fn, recs[name]))

    def undo():
        MD.find_peaks_shifts = orig_peaks
        del dm._compact_hashes
        for a, attr, fn in hooks:
            setattr(a, attr, fn)

    return recs, undo


def batch_step(run: H.Run, st: dict):
    """One window call: ``compute_accuracy_batched`` over a batch of the
    pool; returns each arm's verdicts (``match_waveforms``' returns, taken
    as they pass)."""
    from musicfpaugment_torch.testing.audfprint_exps import compute_accuracy_batched

    s, dm = run.config["audfprint"], st["dm"]
    analyzers = [a for _, a in st["arms"]] + [None]
    calls: list = []
    match = dm.match_waveforms

    def matched(*args, **kw):
        out = match(*args, **kw)
        calls.append(out)
        return out

    dm.match_waveforms = matched

    def step(i: int):
        rows = pool_rows(st, i)
        record = i in st["rec_batches"] and i not in st["records"]
        calls.clear()
        undo = None
        if record:
            recs, undo = recorders(st, calls)
        try:
            compute_accuracy_batched(list(st["pool"][rows]), st["ht"], analyzers[0],
                                     analyzers[1], batch_size=st["B"], shifts=s["shifts"],
                                     device_matcher=dm, names=st["names"][rows],
                                     device=analyzers[0].device)
        finally:
            if undo is not None:
                undo()
        per_arm = list(calls)
        if record:
            for (name, _), verdicts in zip(st["arms"], per_arm):
                recs[name]["verdicts"] = verdicts
            st["records"][i] = recs
        return per_arm

    return step


def run(run: H.Run) -> dict:
    st = setup(run)
    step = batch_step(run, st)
    with run.part("warmup"):
        step(-1)  # every arm once at the batch's shape
    run.end_setup()
    times, elapsed, outs = run.window(step, min_calls=max(st["rec_batches"]) + 1)
    B, n_arms = st["B"], len(st["arms"])
    attempted = B * len(times)
    missing = sum(B * n_arms - sum(len(v) for v in per_arm) for per_arm in outs)
    hashes = {name: [round(float(rec[name]["hashes"][2].float().mean()), 1)
                     for rec in st["records"].values() if rec[name]["hashes"] is not None]
              for name, _ in st["arms"]}
    median = float(np.median(times))
    long = [i for i, t in enumerate(times) if t > 2 * median]
    stretches = sum(1 for j, i in enumerate(long) if j == 0 or long[j - 1] != i - 1)
    print(f"portbench: {len(times)} batches, {attempted} queries, batch ms median "
          f"{1e3 * median:.3f} mean {1e3 * float(np.mean(times)):.3f}, {len(long)} over twice "
          f"the median ({1e3 * sum(times[i] for i in long):.1f} ms, {stretches} stretches, "
          f"batches {long[:1] + long[-1:]}), mean hashes a query in the recorded batches "
          f"{hashes}",
          file=sys.stderr, flush=True)
    measured = {"identify_qps": attempted / elapsed,
                "identify_batch_p95_ms": H.percentile(times, 95) * 1e3}
    device = run.device_record()
    if run.trace:
        traced(run, st, step, elapsed, len(times))
    checks = judge(run, st)
    checks.append(H.Check("missing_verdicts", missing, 0))
    return {"measured": measured, "attempted": attempted, "failed": missing,
            "checks": checks, "device": device}


def traced(run: H.Run, st: dict, step, elapsed: float, n_batches: int) -> None:
    """What the per-layer readers read: the window's model FLOPs and time,
    and a profiled slice of steady batches with the prune kernels'
    launches and shapes."""
    cfg, tr = run.config, run.traffic
    s = cfg["audfprint"]
    B = st["B"]
    q_len = cfg["query_seconds"] * s["samplerate"]
    flops = 0
    if st["model"] is not None:
        flops = I.kind(cfg).batch_flops(cfg, B) * n_batches
    run.layer.update({"model_flops": flops, "window_s": elapsed})
    from musicfpaugment_torch.afp.audfprint import peaks_cuda

    before = dict(peaks_cuda.LAUNCHES)
    k = [0]

    def body():
        t0 = time.perf_counter()
        while k[0] < tr["trace_batches"] or time.perf_counter() - t0 < tr["trace_min_seconds"]:
            step(10_000 + k[0])
            k[0] += 1

    trace = H.profile(run, body)
    launches = {n: peaks_cuda.LAUNCHES[n] - before[n] for n in before}
    # one forward and one backward launch a call: every shift of the batch
    # stacked, (B * shifts, n_fft / 2, frames of the first shift)
    frames = 1 + q_len // s["n_hop"]
    kept = []
    for rec in st["records"].values():
        for arm_rec in rec.values():
            kept.append(sum(int(m.sum()) for m in arm_rec["masks"]))
    run.layer.update({
        "trace": trace, "prune_launches": launches,
        "prune_shape": (B * s["shifts"], s["n_fft"] // 2, frames),
        "prune_kept_peaks": float(np.mean(kept)) if kept else 0.0,
        "traced_batches": k[0],
    })


def sample(run: H.Run, st: dict):
    """The sampled queries of the recorded batches: their waveforms, the
    program's outputs for them (arm by arm) and the table's reference view.
    Frees the program's state: the reference runs after it."""
    B = st["B"]
    per_batch = run.traffic["sample_queries"] // len(st["rec_batches"])
    rows = {i: sorted(st["rng"].choice(B, size=per_batch, replace=False).tolist())
            for i in st["rec_batches"]}
    ht = st["ht"]
    table = J.reference_table(ht.table, ht.counts, ht.names, ht.hashesperid, ht.hashbits,
                              ht.depth, ht.maxtimebits)
    waves, prog = [], {name: {"den": [], "masks": [], "hashes": [], "verdicts": []}
                       for name, _ in st["arms"]}
    for i, r in rows.items():
        waves.append(st["pool"][pool_rows(st, i)][r])
        for name, rec in st["records"][i].items():
            p = prog[name]
            sel = torch.as_tensor(r, device=rec["masks"][0].device)
            p["den"].append([d[sel] for d in rec["den"]])
            p["masks"].append([m[sel] for m in rec["masks"]])
            t, h, nv = (x.cpu().numpy() for x in rec["hashes"])
            p["hashes"] += [I.unique_rows(np.stack([t[q, : nv[q]], h[q, : nv[q]]], axis=1))
                            for q in r]
            p["verdicts"] += [tuple(rec["verdicts"][q]) for q in r]
    waves = torch.cat(waves)
    for p in prog.values():
        p["den"] = [torch.cat(parts) for parts in zip(*p["den"])] if p["den"] and p["den"][0] else []
        p["masks"] = [torch.cat(parts) for parts in zip(*p["masks"])]
    sample_tracks = [int(st["q_ids"][pool_rows(st, i)][q]) for i, r in rows.items() for q in r]
    for key in ("dm", "arms", "model", "pool", "records"):
        st.pop(key, None)
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    return waves, prog, table, sample_tracks


def judge(run: H.Run, st: dict) -> List[H.Check]:
    """The sampled queries of the recorded batches against the plain
    reference, and the table's entries of the tracks they read."""
    missing_records = [i for i in st["rec_batches"] if i not in st["records"]]
    if missing_records:
        return [H.Check("recorded_batches_missing", len(missing_records), 0)]
    short = sum(st["B"] - min(len(rec["verdicts"]), rec["masks"][0].shape[0] if rec["masks"] else 0,
                              rec["hashes"][2].shape[0] if rec["hashes"] else 0)
                for recs in st["records"].values() for rec in recs.values())
    if short:
        return [H.Check("recorded_rows_missing", short, 0)]
    waves, prog, table, sample_tracks = sample(run, st)
    numbers = reference_numbers(run, waves, prog, table, "strict")
    numbers["table_entries"] = table_numbers(run, st, prog, table, sample_tracks)
    limits = H.read_json(os.path.join("portbench", "limits", run.cell["name"] + ".json"))
    return [H.Check(k, v, limits["limits"][k]) for k, v in numbers.items()]


def table_numbers(run: H.Run, st: dict, prog: dict, table, sample_tracks) -> float:
    """Table faults over the tracks the sample reads: its own, and any a
    verdict names."""
    cfg = run.config
    tids = {int(str(v[1])[1:]) for p in prog.values() for v in p["verdicts"] if v[0] == "MATCH"}
    tids = sorted(tids | set(sample_tracks))
    s = cfg["audfprint"]
    waves = I.tracks(st["content"]["corpus"], tids, cfg["track_seconds"] * s["samplerate"],
                     s["samplerate"], run.device)
    return float(J.table_faults(table, tids, J.track_hashes(cfg, waves), run.device))


def reference_numbers(run: H.Run, waves: torch.Tensor, prog: dict, table,
                      precision: str) -> Dict[str, float]:
    """Every arm of the reference at ``precision`` against ``prog``."""
    cfg, dev = run.config, run.device
    hook = None
    if any(name == "denoised" for name in prog):
        weights = I.denoiser_weights(cfg, H.sub_seeds(run.seed, SEED_PARTS)["weights"], dev)
        _, hook = J.reference_denoiser(cfg, dev, weights)
    numbers = {}
    for name, p in prog.items():
        ref = J.reference_outputs(cfg, waves, name, hook, table, precision)
        numbers.update(J.compare(p, ref, name))
    return numbers

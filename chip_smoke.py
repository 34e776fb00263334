"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the audfprint identification path of ``musicfpaugment_torch`` end to
end on the card, through the entry points a user calls:

1. device  - the card's name and power limit;
2. build   - compiles the CUDA kernels from ``musicfpaugment_torch/csrc``;
3. kernels - each prune kernel against its plain PyTorch version on the same
             card tensors, at the shapes the path gives it (a 128-query
             batch of 8 s crops; the 512 rows of that batch's 4 stacked
             shifts, 251 and 250 columns; a 64-track ingest batch of
             20-30 s tracks, mixed lengths), with times, bounds and mismatch
             counts, which must be 0;
4. ingest  - 10,000 synthetic 20-30 s tracks, generated on the card, indexed
             by ``create_fp_database`` into a full 2^20 x 100 ``HashTable``;
5. match   - ``compute_accuracy_batched`` (batch 128, 4 shifts) over 1,024
             clean 8 s crops of indexed tracks, which must reach accuracy
             0.99; 128 crops of tracks never indexed; one batch re-run with
             the plain prunes on the card, which must give the same verdicts;
6. profile - one match batch and one ingest batch under torch.profiler:
             wall time, device time, the card's busy share, the top ops.

Every phase prints a JSON line. Launch counters are zeroed just before
ingest and read after match: both kernels must have launched in each (once
per ingest batch, once per match batch whatever the number of shifts).
The line before the last is the kernel table, the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero.

In the kernel table ``ms``, ``plain_ms`` and ``bound_ms`` are those of the
shape the match path launches (512 stacked rows), ``ms`` the launch on the
time-major tensors as the path calls it and ``wrapper_ms`` the (B, F, C)
wrapper with its transposed copies; ``query_*`` and ``ingest_*`` are the same
readings at the other two shapes.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from musicfpaugment_torch import _build
from musicfpaugment_torch.afp.audfprint import DeviceMatcher, HashTable
from musicfpaugment_torch.afp.audfprint import peaks as P
from musicfpaugment_torch.afp.audfprint import peaks_cuda as K
from musicfpaugment_torch.afp.audfprint.analyzer import (
    AudfprintPeaks,
    pad_waveform_batch,
    valid_frames_for,
)
from musicfpaugment_torch.data.synthetic import synth_tracks_device
from musicfpaugment_torch.testing.audfprint_exps import (
    compute_accuracy_batched,
    create_fp_database,
)
from musicfpaugment_torch.testing.parameters import afp_settings

SR = 8000
N_TRACKS = 10_000
TRACK_SECONDS = (20, 30)
QUERY_SECONDS = 8
N_QUERIES = 1024
N_UNSEEN = 128
QUERY_BATCH = 128
INGEST_BATCH = 64
SHIFTS = 4
CORPUS_SEED = 2023
UNSEEN_SEED = 4049
MIN_CLEAN_ACCURACY = 0.99  # the JAX package's 106k-track proof measured 1.0

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_ms(fn, reps: int) -> float:
    """Mean ms per call on the card's clock, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def track_lengths(n: int, seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    return r.integers(TRACK_SECONDS[0] * SR, TRACK_SECONDS[1] * SR + 1, n)


def make_tracks(seed: int, n: int, lengths: np.ndarray, dev) -> list:
    """n tracks on the card, track i a pure function of (seed, i), each cut
    to its own length."""
    out = []
    for s in range(0, n, 128):
        idx = list(range(s, min(s + 128, n)))
        block = synth_tracks_device(seed, idx, TRACK_SECONDS[1] * SR, SR, device=dev)
        out += [block[j, : int(lengths[i])] for j, i in enumerate(idx)]
    return out


def crops_of(tracks, ids, offsets) -> list:
    n = QUERY_SECONDS * SR
    return [tracks[int(t)][int(o) : int(o) + n] for t, o in zip(ids, offsets)]


def prune_work(x, fwd, bwd, vf):
    """Bytes each prune must move and f32 operations it does on these
    inputs (counted from this run's masks: one argmax round and one bump per
    forward peak, one bump per kept peak)."""
    B, F, C = x.shape
    cells = B * F * C
    valid_cols = B * C if vf is None else int(vf.sum())
    tested = int(fwd.sum())
    spread = 2 * B * F * F  # initial envelope
    fwd_ops = 5 * cells + F * tested + 2 * F * tested + spread
    bwd_ops = 2 * F * valid_cols + F * tested + 2 * F * int(bwd.sum()) + spread
    fwd_bytes = cells * 4 + cells + F * 4
    bwd_bytes = cells * 4 + 2 * cells + F * 4 + B * 4
    return (fwd_bytes, fwd_ops), (bwd_bytes, bwd_ops)


def bound(bytes_, ops):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(name, x, vf, sm_mhz):
    """Kernel vs plain on the same card tensors at one path shape: 0
    mismatching cells required. ``ms`` times the (B, F, C) wrapper (the
    transposed copies and the launch), ``kernel_ms`` the launch alone on the
    time-major tensors, as the path calls it, ``step_cycles_at_max_clock``
    that launch per column of the longest row, reckoned at the card's maximum
    SM clock (the clock the run had is not read)."""
    a_dec = P.prune_decay(20.0, 256)
    fk = K.forward_prune_cuda(x, a_dec)
    fp = P.forward_prune(x, a_dec, 30.0, 5)
    bk = K.backward_prune_cuda(x, fp, a_dec, 30.0, 5, vf)
    bp = P.backward_prune(x, fp, a_dec, 30.0, 5, vf)
    tm = x.transpose(1, 2).contiguous()
    fk_tm = K.forward_prune_tm(tm, a_dec)
    bk_tm = K.backward_prune_tm(tm, fk_tm, a_dec, 30.0, 5, vf)
    torch.cuda.synchronize()
    (fb, fo), (bb, bo) = prune_work(x, fp, bp, vf)
    steps = x.shape[2] if vf is None else int(vf.max())
    out = {}
    for kname, got, got_tm, want, kfn, tmfn, pfn, nbytes, nops in (
        ("forward_prune", fk, fk_tm, fp,
         lambda: K.forward_prune_cuda(x, a_dec),
         lambda: K.forward_prune_tm(tm, a_dec),
         lambda: P.forward_prune(x, a_dec, 30.0, 5), fb, fo),
        ("backward_prune", bk, bk_tm, bp,
         lambda: K.backward_prune_cuda(x, fp, a_dec, 30.0, 5, vf),
         lambda: K.backward_prune_tm(tm, fk_tm, a_dec, 30.0, 5, vf),
         lambda: P.backward_prune(x, fp, a_dec, 30.0, 5, vf), bb, bo),
    ):
        mism = int((got != want).sum()) + int((K.as_bool_masks(got_tm) != want).sum())
        b_ms, b_by = bound(nbytes, nops)
        kernel_ms = gpu_ms(tmfn, 20)
        out[kname] = {
            "shape": name, "B": x.shape[0], "F": x.shape[1], "C": x.shape[2],
            "mismatch": mism,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "peaks": int(want.sum()),
            "ms": gpu_ms(kfn, 20), "kernel_ms": kernel_ms,
            "step_cycles_at_max_clock": kernel_ms * 1e-3 * sm_mhz * 1e6 / steps,
            "plain_ms": gpu_ms(pfn, 2),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": nops,
        }
        if mism:
            fail(f"{kname} at the {name} shape disagrees with its plain version "
                 f"in {mism} cells")
    return out


def plain_tm(mask: torch.Tensor) -> torch.Tensor:
    """(B, F, C) bool mask of a plain prune -> the (B, C, F) 0/1 bytes the
    kernels' route carries."""
    return mask.transpose(1, 2).to(torch.uint8).contiguous()


def _device_us(evt) -> float:
    return getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)


def profile_call(label: str, fn) -> dict:
    """One call's wall time (plain, then under torch.profiler), the summed
    device time of its kernels, the card's busy share and the top ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events (kernels, copies) carry the card's time once; the
    # host ops that launched them repeat it, so they only rank
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    host_ops = [e for e in events if e.device_type != DeviceType.CUDA]
    device_ms = sum(_device_us(e) for e in on_card) / 1e3

    def top(evts, n=8):
        return [
            {"name": e.key[:80], "device_ms": _device_us(e) / 1e3, "count": e.count}
            for e in sorted(evts, key=_device_us, reverse=True)[:n]
        ]

    prune_ms = sum(
        _device_us(e) for e in on_card if "fwd_kernel" in e.key or "bwd_kernel" in e.key
    ) / 1e3
    return {
        "phase": "profile", "call": label, "wall_ms": wall_ms,
        "traced_wall_ms": traced_ms, "device_ms": device_ms,
        "busy_share": device_ms / traced_ms,
        "prune_kernels_device_ms": prune_ms,
        "prune_kernels_share_of_device": prune_ms / device_ms,
        "top_ops": top(host_ops), "top_kernels": top(on_card),
    }


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    sm_mhz = float(clk.stdout.strip().splitlines()[0])
    emit({"phase": "device", "name": kind, "nvidia_smi": smi_line,
          "max_sm_mhz": sm_mhz, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib})

    # ---- corpus and queries (set-up, on the card)
    t0 = time.perf_counter()
    lengths = track_lengths(N_TRACKS, CORPUS_SEED)
    tracks = make_tracks(CORPUS_SEED, N_TRACKS, lengths, dev)
    r = np.random.default_rng(CORPUS_SEED + 1)
    q_ids = r.integers(0, N_TRACKS, N_QUERIES)
    q_offs = [r.integers(0, int(lengths[t]) - QUERY_SECONDS * SR) for t in q_ids]
    queries = crops_of(tracks, q_ids, q_offs)
    names = [f"track{i:05d}" for i in range(N_TRACKS)]
    u_len = track_lengths(N_UNSEEN, UNSEEN_SEED)
    unseen_tracks = make_tracks(UNSEEN_SEED, N_UNSEEN, u_len, dev)
    unseen = torch.stack(crops_of(unseen_tracks, range(N_UNSEEN), [SR] * N_UNSEEN))
    torch.cuda.synchronize()
    emit({"phase": "corpus", "tracks": N_TRACKS, "seconds": time.perf_counter() - t0,
          "samples": int(lengths.sum())})

    # ---- 3. kernels vs plain at the path's shapes
    q_batch = torch.stack(queries[:QUERY_BATCH])
    x_query = P.prune_input(q_batch)
    ing, valid = pad_waveform_batch(
        tracks[:INGEST_BATCH], pad_to=TRACK_SECONDS[1] * SR, device=dev
    )
    vf_ing = torch.as_tensor(valid_frames_for(valid.astype(np.int64)), dtype=torch.int32, device=dev)
    x_ingest = P.prune_input(ing, valid_frames=vf_ing)
    # the 4 shifts of the query batch as match_waveforms stacks them
    offs = [int(s / SHIFTS * 256) for s in range(SHIFTS)]
    x_stacked, vf_stacked, n_cols = P.stacked_prune_input([q_batch[:, o:] for o in offs])
    if tuple(x_stacked.shape) != (SHIFTS * QUERY_BATCH, 256, 251) or n_cols != [251, 250, 250, 250]:
        fail(f"unexpected stacked shape {tuple(x_stacked.shape)}, columns {n_cols}")
    at_query = check_kernels("query", x_query, None, sm_mhz)
    at_stacked = check_kernels("stacked", x_stacked, vf_stacked, sm_mhz)
    at_ingest = check_kernels("ingest", x_ingest, vf_ing, sm_mhz)
    emit({"phase": "kernels", "query": at_query, "stacked": at_stacked,
          "ingest": at_ingest})

    # ---- 4. ingest (launch counters zeroed just before the main path)
    K.reset_launch_counts()
    analyzer = AudfprintPeaks(afp_settings["audfprint"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ht = create_fp_database(
        tracks, None, analyzer=analyzer, batch_size=INGEST_BATCH,
        hash_tab=HashTable(), names=names, device=dev,
    )
    ingest_s = time.perf_counter() - t0
    launches_ingest = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    dm = DeviceMatcher(ht, device=dev)
    torch.cuda.synchronize()
    emit({
        "phase": "ingest", "tracks": N_TRACKS, "seconds": ingest_s,
        "tracks_per_s": N_TRACKS / ingest_s, "total_hashes": ht.totalhashes(),
        "table": [int(1 << ht.hashbits), int(ht.depth)], "eff_depth": dm.eff_depth,
        "eff_maxtime": dm.eff_maxtime, "device_table_bytes": dm.table_bytes(),
        "matcher_setup_s": time.perf_counter() - t0, "launches": launches_ingest,
    })
    if (ht.table.shape != (1 << 20, 100)) or len(ht.names) != N_TRACKS:
        fail("the ingest did not fill a 2^20 x 100 table with every track")

    # ---- 5. match
    t0 = time.perf_counter()
    acc = compute_accuracy_batched(
        queries, ht, analyzer, batch_size=QUERY_BATCH, shifts=SHIFTS,
        device_matcher=dm, names=[names[int(t)] for t in q_ids], device=dev,
    )
    match_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    unseen_v = dm.match_waveforms(unseen, shifts=SHIFTS)
    unseen_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    launches_match = {k: launches[k] - launches_ingest[k] for k in launches}
    nomatch = sum(v[0] == "NOMATCH" for v in unseen_v) / N_UNSEEN

    # one batch again with the plain prunes on the card: same verdicts
    kernel_v = dm.match_waveforms(q_batch, shifts=SHIFTS)
    fwd_k, bwd_k = K.forward_prune_tm, K.backward_prune_tm
    K.forward_prune_tm = lambda tm, a, f=30.0, m=5: plain_tm(
        P.forward_prune(tm.transpose(1, 2), a, f, m))
    K.backward_prune_tm = lambda tm, p, a, f=30.0, m=5, vf=None: plain_tm(
        P.backward_prune(tm.transpose(1, 2), K.as_bool_masks(p), a, f, m, vf))
    K.reset_launch_counts()
    try:
        plain_v = dm.match_waveforms(q_batch, shifts=SHIFTS)
    finally:
        K.forward_prune_tm, K.backward_prune_tm = fwd_k, bwd_k
    if any(K.LAUNCHES.values()):
        fail("the plain re-run launched a kernel")
    emit({
        "phase": "match", "queries": N_QUERIES, "shifts": SHIFTS, "accuracy": acc,
        "seconds": match_s, "queries_per_s": N_QUERIES / match_s,
        "unseen_queries": N_UNSEEN, "unseen_nomatch_rate": nomatch,
        "unseen_queries_per_s": N_UNSEEN / unseen_s, "launches": launches_match,
        "plain_rerun_verdicts_equal": plain_v == kernel_v,
    })
    if acc["No Denoising"] < MIN_CLEAN_ACCURACY:
        fail(f"clean accuracy {acc['No Denoising']} < {MIN_CLEAN_ACCURACY}")
    for k in launches:
        if launches_ingest[k] <= 0 or launches_match[k] <= 0:
            fail(f"{k} kernel did not launch in both ingest and match: "
                 f"{launches_ingest[k]}, {launches_match[k]}")
    if plain_v != kernel_v:
        fail("plain prunes on the card gave other verdicts than the kernels")

    # ---- 6. where the time goes: one match batch, one ingest batch
    emit(profile_call("match_waveforms, 128 queries, 4 shifts",
                      lambda: dm.match_waveforms(q_batch, shifts=SHIFTS)))
    scratch = HashTable()
    ing_names = names[:INGEST_BATCH]
    emit(profile_call("ingest_batch, 64 tracks",
                      lambda: analyzer.ingest_batch(scratch, ing_names, ing, valid_samples=valid)))
    t0 = time.perf_counter()
    hashes = analyzer.hashes_batch(ing, shifts=1, valid_samples=valid)
    t1 = time.perf_counter()
    for n, h in zip(ing_names, hashes):
        scratch.store(n, h)
    t2 = time.perf_counter()
    emit({"phase": "profile", "call": "ingest_batch split, 64 tracks",
          "hashes_batch_ms": (t1 - t0) * 1e3, "host_store_ms": (t2 - t1) * 1e3})

    kernels = []
    for kname, line in (("forward_prune", 60), ("backward_prune", 113)):
        q, i, st = at_query[kname], at_ingest[kname], at_stacked[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "musicfpaugment_torch/csrc/peaks_prune.cu",
            "replaces": f"musicfpaugment_tpu/afp/audfprint/peaks_pallas.py:{line}",
            "launches": launches[kname],
            "launches_ingest": launches_ingest[kname],
            "launches_match": launches_match[kname],
            "max_abs_err": max(q["max_abs_err"], i["max_abs_err"], st["max_abs_err"]),
            "ms": st["kernel_ms"], "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": None, "shape": "stacked",
            "kernel_ms": st["kernel_ms"], "wrapper_ms": st["ms"],
            "query_kernel_ms": q["kernel_ms"], "query_wrapper_ms": q["ms"],
            "query_plain_ms": q["plain_ms"], "query_bound_ms": q["bound_ms"],
            "ingest_kernel_ms": i["kernel_ms"], "ingest_wrapper_ms": i["ms"],
            "ingest_plain_ms": i["plain_ms"], "ingest_bound_ms": i["bound_ms"],
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    main()

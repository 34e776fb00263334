"""Reference-scale Dejavu identification proof (port of
examples/dejavu_scale.py), the companion of ``scale_proof`` for the second
fingerprinting system.

The same storage-free corpus as ``scale_proof`` (same default seed, so the
same tracks) is indexed into a :class:`DejavuDeviceIndex` and queried
through :class:`DejavuDeviceMatcher` under the paper's 11 conditions.

Stages (resumable and bounded by ``--minutes``; state in ``--workdir``):

  ingest  - each batch generated, PSD spectrogram, max-filter peaks, packed
            hashes, per-song dedup and valid-first compaction on the card,
            read back behind the next batch's launch; the raw index is saved
            at the end of each invocation.
  match   - ``finalize`` (a host sort of every row into the CSR arrays,
            each hot key cut to ``--hash-cap`` rows), the upload,
            then the conditions through the batched matcher: accuracy and
            queries/s; with ``--denoise`` also the UNet arm (the checkpoint
            ``scale_proof train`` writes) and the mix rule on
            ``nb_matches_with_offset``.
  oracle  - device verdicts against an independent Python
            ``return_matches`` + ``align_matches`` over the same CSR rows.
  report  - the state as ``--out`` (default ``<workdir>/dejavu_results.json``).

Run on the card:
  python -m musicfpaugment_torch.testing.dejavu_scale ingest --minutes 8
  python -m musicfpaugment_torch.testing.dejavu_scale match --banks dcase --denoise
  python -m musicfpaugment_torch.testing.dejavu_scale oracle
  python -m musicfpaugment_torch.testing.dejavu_scale report
Every stage runs on CUDA and raises without it unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint.landmarks import compact_valid_first
from musicfpaugment_torch.afp.dejavu import DejavuDeviceIndex, DejavuDeviceMatcher
from musicfpaugment_torch.afp.dejavu.fingerprint import (
    fingerprint_spectrogram_batch,
    pack_hashes,
    pack_hashes_from_masks,
    peaks_from_mask,
)
from musicfpaugment_torch.afp.dejavu.variables import MIN_HASHES
from musicfpaugment_torch.device import resolve_device
from musicfpaugment_torch.testing.parameters import test_pipelines_parameters
from musicfpaugment_torch.testing.scale_proof import (
    SR,
    TRACK_SECONDS,
    Tracks,
    condition_augmenter,
    condition_batches,
    corpus_tracks,
    default_workdir,
    load_state,
    load_unet,
    make_queries,
    query_plan,
    require_ingest,
    save_state,
    select_conditions,
    sync,
    write_report,
)

HCAP = 2048  # per-track deduplicated-hash budget (a 30 s track yields ~700)


def _index_path(workdir: str) -> str:
    return os.path.join(workdir, "dejavu_index.npz")


def ingest_max_peaks(num_samples: int) -> int:
    """The per-track peak budget: 4 peaks a frame, rounded up to 128."""
    n_frames = 1 + (num_samples - 512) // 256
    return -(-4 * n_frames // 128) * 128


def ingest_rows(wavs: torch.Tensor, max_peaks: int):
    """(B, T) tracks -> ((B, HCAP, 2) int32 (key, offset) rows, valid
    first, (B,) stored counts, tracks past HCAP plus tracks past the peak
    budget), on the tracks' device."""
    _, masks, _ = fingerprint_spectrogram_batch(wavs, SR, 512, 256, 50.0)
    keys, t1, valid, _kf, _n_distinct, n_po = pack_hashes_from_masks(masks, max_peaks)
    k, t, nv = compact_valid_first(keys, t1, valid, out_len=HCAP)
    return torch.stack([k, t], dim=-1), torch.clamp(nv, max=HCAP), (nv > HCAP).sum() + n_po


def stage_ingest(args, tracks: Optional[Tracks] = None) -> None:
    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    state = load_state(args.workdir)
    start = state.get("next_track", 0)
    if start >= args.tracks:
        print("ingest complete:", start, "tracks", flush=True)
        return
    if os.path.exists(_index_path(args.workdir)):
        idx = DejavuDeviceIndex.load(_index_path(args.workdir))
        if len(idx.names) != start:
            raise RuntimeError(f"the index holds {len(idx.names)} tracks, the state {start}")
    else:
        idx = DejavuDeviceIndex(max_rows_per_hash=args.hash_cap)
    max_peaks = ingest_max_peaks(TRACK_SECONDS * SR)
    tracks = tracks or corpus_tracks(args.corpus_seed, dev)

    deadline = time.time() + args.minutes * 60
    batch_times = state.get("ingest_batch_seconds", [])
    overflow = state.get("hash_overflow", 0)

    def drain(pending):
        nonlocal overflow
        p_start, p_n, (kt, counts, over) = pending
        kt, counts = kt.cpu().numpy(), counts.cpu().numpy()
        for j in range(p_n):
            n = int(counts[j])
            idx.names.append(f"t{p_start + j:06d}")
            idx.total_hashes.append(n)
            idx._keys.append(kt[j, :n, 0].astype(np.int32))
            idx._offs.append(kt[j, :n, 1].astype(np.int32))
        overflow += int(over)

    pending = None
    t0 = time.perf_counter()
    while start < args.tracks and time.time() < deadline:
        n = min(args.batch, args.tracks - start)
        out = ingest_rows(tracks(np.arange(start, start + args.batch)), max_peaks)
        if pending is not None:
            drain(pending)
        pending = (start, n, out)
        start += n
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch_times.append(round(dt, 3))
        if len(batch_times) % 40 == 0 or start >= args.tracks:
            print(f"ingested {start}/{args.tracks} ({args.batch / dt:.1f} tracks/s last batch)",
                  flush=True)
    if pending is not None:
        drain(pending)
    idx._frozen = None
    idx.save(_index_path(args.workdir))
    state.update(
        next_track=start,
        ingest_batch_seconds=batch_times[-200:],
        hash_overflow=overflow,
        tracks_target=args.tracks,
        hash_cap=args.hash_cap,
    )
    if start >= args.tracks:
        steady = np.median(batch_times[5:]) if len(batch_times) > 5 else None
        state.update(
            ingest_done=True,
            total_rows=int(sum(idx.total_hashes)),
            ingest_tracks_per_sec=round(args.batch / steady, 1) if steady else None,
        )
        shown = {k: v for k, v in state.items() if k != "ingest_batch_seconds"}
        print("ingest complete:", json.dumps(shown, indent=2), flush=True)
    save_state(args.workdir, state)


def load_index(workdir: str) -> DejavuDeviceIndex:
    """The saved raw index, to finalize once and hand to several stages
    (their ``index=``) in one process."""
    return DejavuDeviceIndex.load(_index_path(workdir))


def load_matcher(args, state: dict, index: Optional[DejavuDeviceIndex] = None):
    """The index loaded and finalized (``finalize_s`` counts both), and put
    on the card; records the CSR figures in ``state``. A given ``index`` is
    used as it is: its CSR is finalized once, and the caller times that."""
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    idx = index if index is not None else load_index(args.workdir)
    starts, rows, _nbuckets, depth = idx.finalize()
    finalize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dm = DejavuDeviceMatcher(idx, device=dev)
    sync(dev)
    upload_s = time.perf_counter() - t0
    index_mb = (rows.nbytes + starts.nbytes) / 1e6
    print(f"matcher ready: rows={rows.size} depth={depth} index={index_mb:.0f}MB "
          f"(CSR prefix {starts.nbytes / 1e6:.0f}MB) hot-key rows dropped={idx.rows_dropped} "
          f"finalize {finalize_s:.1f}s upload {upload_s:.1f}s", flush=True)
    state.update(
        total_rows_stored=int(rows.size),
        bucket_depth=int(depth),
        index_mb=round(index_mb, 1),
        rows_dropped=int(idx.rows_dropped),
        index_upload_s=round(upload_s, 1),
    )
    if index is None:
        state["finalize_s"] = round(finalize_s, 1)
    return idx, dm


def is_hit(r: dict, tid) -> bool:
    return bool(
        r and r["nb_matches_with_offset"] > MIN_HASHES
        and r["song_name"].decode() == f"t{int(tid):06d}"
    )


def score_batch(res, res_den, tids, den_active: bool):
    """(correct, correct denoised, correct mix) of one batch. The mix rule
    takes the result with more offset-aligned matches, the undenoised one
    on a tie; an empty result loses to any other."""
    correct = correct_den = correct_mix = 0
    for r, rd, tid in zip(res, res_den, tids):
        correct += is_hit(r, tid)
        if den_active:
            correct_den += is_hit(rd, tid)
            nm = r["nb_matches_with_offset"] if r else -1
            nmd = rd["nb_matches_with_offset"] if rd else -1
            correct_mix += is_hit(r if nm >= nmd else rd, tid)
    return correct, correct_den, correct_mix


def stage_match(args, tracks: Optional[Tracks] = None, index: Optional[DejavuDeviceIndex] = None) -> None:
    dev = resolve_device(args.device)
    state = load_state(args.workdir)
    require_ingest(state)
    idx, dm = load_matcher(args, state, index)
    tracks = tracks or corpus_tracks(args.corpus_seed, dev)

    # every query also through the UNet-denoised matcher, which reuses the
    # index's finalized CSR and puts its own copy on the card
    dm_den = None
    if args.denoise:
        dm_den = DejavuDeviceMatcher(idx, spec_denoiser=load_unet(args.unet_pkl, dev), device=dev)

    qidx, offsets = query_plan(state["tracks_target"], args.queries, 42)
    conditions = select_conditions(args.conditions)

    warm = make_queries(tracks, qidx[: args.batch], offsets[: args.batch])
    dm.match_waveforms(warm)
    if dm_den is not None:
        dm_den.match_waveforms(warm)

    results = state.get("conditions", {})
    for cond, params in conditions.items():
        if cond in results and not args.rerun:
            continue
        fp = condition_augmenter(params, args) if params is not None else None
        correct = correct_den = correct_mix = n_done = 0
        match_s = match_den_s = 0.0
        t_cond = time.perf_counter()
        for _, tids, crops in condition_batches(tracks, fp, qidx, offsets, args.batch):
            sync(dev)
            t0 = time.perf_counter()
            res = dm.match_waveforms(crops)
            match_s += time.perf_counter() - t0
            if dm_den is not None:
                t0 = time.perf_counter()
                res_den = dm_den.match_waveforms(crops)
                match_den_s += time.perf_counter() - t0
            else:
                res_den = res
            c, cd, cm = score_batch(res, res_den, tids, dm_den is not None)
            correct, correct_den, correct_mix = correct + c, correct_den + cd, correct_mix + cm
            n_done += len(tids)
        results[cond] = {
            "accuracy": round(correct / max(n_done, 1), 4),
            "n_queries": n_done,
            "match_qps": round(n_done / match_s, 1),
            "wall_s": round(time.perf_counter() - t_cond, 1),
        }
        if dm_den is not None:
            results[cond].update(
                accuracy_den=round(correct_den / max(n_done, 1), 4),
                accuracy_mix=round(correct_mix / max(n_done, 1), 4),
                match_den_qps=round(n_done / match_den_s, 1),
            )
        print(cond, results[cond], flush=True)
        state["conditions"] = results
        state["match_batch"] = args.batch
        state["match_banks"] = args.banks
        state["match_denoise"] = bool(dm_den is not None)
        save_state(args.workdir, state)


def python_align_oracle(starts, rows, timebits: int, names, query_hashes):
    """Python ``return_matches`` + ``align_matches`` over the CSR rows:
    per (song, dt) counts, each song's best offset (ties to the smallest
    dt), the song with the most (ties to the smallest id), and its rows
    counted once per distinct key."""
    cell = defaultdict(int)
    dedup = defaultdict(int)
    seen_keys = set()
    tmask = (1 << timebits) - 1
    for key, t1 in query_hashes:
        if key + 1 >= len(starts):
            continue  # past the stored key space; the device masks it too
        first_key = key not in seen_keys
        seen_keys.add(key)
        for row in rows[starts[key] : starts[key + 1]]:
            sid = int(row) >> timebits
            cell[(sid, (int(row) & tmask) - t1)] += 1
            if first_key:
                dedup[sid] += 1
    if not cell:
        return None
    per_song = {}
    for (sid, dt), c in sorted(cell.items()):
        best = per_song.get(sid)
        if best is None or c > best[1]:
            per_song[sid] = (dt, c)
    best_sid = max(sorted(per_song), key=lambda s: per_song[s][1])
    dt, c = per_song[best_sid]
    return {
        "song_name": names[best_sid],
        "nb_matches_with_offset": c,
        "hashes_matched": dedup[best_sid],
        "offset": dt,
    }


def stage_oracle(args, tracks: Optional[Tracks] = None, index: Optional[DejavuDeviceIndex] = None) -> None:
    """``--oracle-n`` ``bn_p10`` queries (plan seed 43): the device results
    against :func:`python_align_oracle` on the same masks' hashes, every
    field."""
    dev = resolve_device(args.device)
    state = load_state(args.workdir)
    require_ingest(state)
    idx, dm = load_matcher(args, state, index)
    starts, rows, _nb, _d = idx.finalize()
    tracks = tracks or corpus_tracks(args.corpus_seed, dev)
    n = args.oracle_n
    qidx, offsets = query_plan(state["tracks_target"], n, 43)
    fp = condition_augmenter(test_pipelines_parameters["bn_p10"], args)
    aug = fp.batch_augment_indexed(make_queries(tracks, qidx, offsets)[:, None, :], np.arange(n))[:, 0, :]
    device_results = dm.match_waveforms(aug)
    masks = fingerprint_spectrogram_batch(aug, SR, 512, 256, 50.0)[1].cpu().numpy()
    agree = 0
    for i in range(n):
        qh = sorted(set(pack_hashes(peaks_from_mask(masks[i]))))
        ov = python_align_oracle(starts, rows, idx.timebits, idx.names, qh)
        dv = device_results[i]
        if ov is None:
            same = dv == {}
        else:
            same = (
                bool(dv)
                and dv["song_name"].decode() == ov["song_name"]
                and dv["nb_matches_with_offset"] == ov["nb_matches_with_offset"]
                and dv["hashes_matched_in_input"] == ov["hashes_matched"]
                and dv["offset"] == ov["offset"]
            )
        agree += int(same)
        if not same:
            print("DISAGREE", i, "oracle:", ov, "device:", dv, flush=True)
    state["oracle_agreement"] = f"{agree}/{n}"
    save_state(args.workdir, state)
    print("oracle agreement:", agree, "/", n, flush=True)


def stage_report(args) -> None:
    write_report(args.workdir, args.out, "dejavu_results.json")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("stage", choices=["ingest", "match", "oracle", "report"])
    p.add_argument("--workdir", default=default_workdir("dejavu_scale"))
    p.add_argument("--out", default=None, help="report file (default <workdir>/dejavu_results.json)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tracks", type=int, default=106574)  # |FMA-large|
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--minutes", type=float, default=8.0)
    p.add_argument("--conditions", default="all")
    p.add_argument("--corpus-seed", type=int, default=1234)
    p.add_argument("--oracle-n", type=int, default=32)
    # at 106,574 tracks the deepest key holds ~500 rows: 1024 drops none
    p.add_argument("--hash-cap", type=int, default=1024)
    p.add_argument("--banks", choices=["toy", "dcase"], default="toy")
    p.add_argument("--bank-hours", type=float, default=2.0)
    p.add_argument("--denoise", action="store_true",
                   help="also run the UNet-denoised matcher and the mix rule")
    p.add_argument("--unet-pkl", default=os.path.join(default_workdir("scale_proof"), "unet.pt"),
                   help="the UNet checkpoint that scale_proof's train stage writes; one "
                        "checkpoint serves both systems")
    p.add_argument("--rerun", action="store_true")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser().parse_args(argv)
    resolve_device(args.device)  # CUDA unless --device cpu; raises without it
    dict(
        ingest=stage_ingest, match=stage_match, oracle=stage_oracle, report=stage_report,
    )[args.stage](args)


if __name__ == "__main__":
    main()

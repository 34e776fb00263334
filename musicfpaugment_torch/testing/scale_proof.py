"""Reference-scale identification proof for audfprint (port of
examples/scale_proof.py).

The paper's headline workload is a 106,574-track index (the size of
FMA-large) queried by 8 s crops under the 11 conditions. The corpus here is
storage-free: track ``i`` is a pure function of ``(--corpus-seed, i)``
(``data/synthetic.synth_tracks_device``), so the corpus is indexed and its
queries regenerated on the card without a waveform ever crossing from the
host. Its draws are the JAX package's (threefry keys), so track ``i`` is
the JAX package's track ``i`` on every device, and so are the queries.

Stages (each resumable and bounded by ``--minutes``; state in
``--workdir``):

  ingest  - each batch of tracks generated, peak-picked (the CUDA prunes),
            hashed, deduplicated and compacted on the card; batch k + 1 is
            launched before batch k is read back and stored, so the host's
            reservoir-sampling store overlaps the card's work. The table is
            saved (uncompressed) at the end of each invocation. A resumed
            ingest reloads the table, whose reservoir stream restarts at
            ``default_rng(0)`` as the JAX package's does, so equal chunks
            give equal tables and a chunked table differs from an
            uninterrupted one once buckets overflow.
  train   - the denoiser that ``match --denoise`` uses: the UNet
            (``workdir/unet.pt``) or, with ``--model demucs``, Demucs
            (``workdir/demucs.pt``), trained on synthetic clean batches with
            the match conditions' banks inside each step.
  match   - the whole 2^20 x 100 table on the card, then the conditions
            through ``DeviceMatcher.match_waveforms``: accuracy and
            queries/s; with ``--denoise`` also the denoised arm and the mix
            rule (more aligned hashes wins, ties to the undenoised verdict).
  peaks   - peak precision / recall / F1 and spectrogram PSNR of the same
            crops against their clean versions.
  oracle  - device verdicts against the numpy ``Matcher`` at full depth.
  report  - the state as ``--out`` (default ``<workdir>/results.json``),
            with the keys of the JAX package's ``results.json``.

Run on the card (chunked):
  python -m musicfpaugment_torch.testing.scale_proof ingest --minutes 8
  ... again until "ingest complete" ...
  python -m musicfpaugment_torch.testing.scale_proof train --banks dcase
  python -m musicfpaugment_torch.testing.scale_proof match --queries 10000 \\
      --shifts 4 --banks dcase --denoise
  python -m musicfpaugment_torch.testing.scale_proof peaks --queries 10000 --banks dcase
  python -m musicfpaugment_torch.testing.scale_proof oracle --shifts 4
  python -m musicfpaugment_torch.testing.scale_proof report
Every stage runs on CUDA and raises without it unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable, Matcher
from musicfpaugment_torch.afp.audfprint import landmarks as lm
from musicfpaugment_torch.afp.audfprint.peaks import find_peaks_batch, spectrogram_frontend
from musicfpaugment_torch.augment import AugmentFP, dcase_shaped_banks, synthetic_banks
from musicfpaugment_torch.convert import demucs_denoiser, unet_denoiser
from musicfpaugment_torch.data.synthetic import synth_tracks_device, synthetic_clean_batches
from musicfpaugment_torch.device import resolve_device
from musicfpaugment_torch.models import Demucs, UNet
from musicfpaugment_torch.testing.metrics import batch_peak_metrics, batch_psnr
from musicfpaugment_torch.testing.parameters import afp_settings, test_pipelines_parameters
from musicfpaugment_torch.train.trainer import Trainer

SR = 8000
TRACK_SECONDS = 30
QUERY_SECONDS = 8
HCAP = 4096  # per-track hash budget (a 30 s track yields ~1k)

Tracks = Callable[[np.ndarray], torch.Tensor]


def _state_path(workdir: str) -> str:
    return os.path.join(workdir, "state.json")


def load_state(workdir: str) -> dict:
    if os.path.exists(_state_path(workdir)):
        with open(_state_path(workdir)) as f:
            return json.load(f)
    return {}


def save_state(workdir: str, state: dict) -> None:
    with open(_state_path(workdir), "w") as f:
        json.dump(state, f, indent=2)


def _table_path(workdir: str) -> str:
    return os.path.join(workdir, "table.npz")


def require_ingest(state: dict) -> None:
    if not state.get("ingest_done"):
        raise RuntimeError("run ingest to completion first")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def corpus_tracks(seed: int, device: torch.device) -> Tracks:
    """indices -> (B, 30 s) tracks of the storage-free corpus on ``device``."""

    def tracks(indices):
        return synth_tracks_device(seed, indices, TRACK_SECONDS * SR, SR, device=device)

    return tracks


def make_queries(tracks: Tracks, qidx, offsets) -> torch.Tensor:
    """Clean 8 s crops of the indexed tracks, cut on the card."""
    full = tracks(np.asarray(qidx))
    offs = torch.as_tensor(np.asarray(offsets, np.int64), device=full.device)
    cols = offs[:, None] + torch.arange(QUERY_SECONDS * SR, device=full.device)
    return torch.gather(full, 1, cols)


def query_plan(n_tracks: int, n: int, seed: int):
    """(track ids, crop offsets) of ``n`` queries from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    qidx = rng.integers(0, n_tracks, n).astype(np.int32)
    offsets = rng.integers(0, (TRACK_SECONDS - QUERY_SECONDS) * SR, n).astype(np.int32)
    return qidx, offsets


def select_conditions(spec: str, with_cleans: bool = True) -> dict:
    conditions = {"cleans": None} if with_cleans else {}
    conditions.update(test_pipelines_parameters)
    if spec != "all":
        keep = set(spec.split(","))
        conditions = {k: v for k, v in conditions.items() if k in keep}
    return conditions


def ingest_hashes(wavs: torch.Tensor):
    """(B, T) tracks -> ((B, HCAP, 2) int32 (time, hash) rows, valid first,
    (B,) stored counts, number of tracks past HCAP), on the tracks' device:
    peaks, landmark hashes, dedup and compaction."""
    masks = find_peaks_batch(wavs)
    C = int(masks.shape[-1])
    max_peaks = -(-5 * C // 128) * 128
    th, v = lm.hashes_from_masks_batched(
        masks, max_peaks=max_peaks, max_hashes=max_peaks * lm.MAXPAIRSPERPEAK
    )
    t, h, v = lm.sort_dedup_hashes(th[..., 0], th[..., 1], v)
    t, h, n = lm.compact_valid_first(t, h, v, out_len=HCAP)
    return torch.stack([t, h], dim=-1), torch.clamp(n, max=HCAP), (n > HCAP).sum()


def table_statistics(ht) -> dict:
    """The saturation figures of a table: hashes offered and kept, the
    share dropped by reservoir sampling, buckets at and over depth."""
    stored = int(np.sum(np.minimum(ht.depth, ht.counts)))
    total = ht.totalhashes()
    return dict(
        total_hashes=total,
        stored_hashes=stored,
        reservoir_dropped_pct=round(100.0 * (total - stored) / max(total, 1), 3),
        buckets_at_depth=int(np.sum(ht.counts >= ht.depth)),
        buckets_over_depth=int(np.sum(ht.counts > ht.depth)),
        max_bucket_count=int(ht.counts.max()),
    )


def stage_ingest(args, tracks: Optional[Tracks] = None) -> None:
    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    state = load_state(args.workdir)
    start = state.get("next_track", 0)
    if start >= args.tracks:
        print("ingest complete:", start, "tracks", flush=True)
        return
    path = _table_path(args.workdir)
    ht = HashTable(path) if os.path.exists(path) else HashTable()
    tracks = tracks or corpus_tracks(args.corpus_seed, dev)

    deadline = time.time() + args.minutes * 60
    batch_times = state.get("ingest_batch_seconds", [])
    overflow = state.get("hash_overflow", 0)

    def drain(pending):
        nonlocal overflow
        p_start, p_n, (th, counts, over) = pending
        th, counts = th.cpu().numpy(), counts.cpu().numpy()
        for j in range(p_n):
            ht.store(f"t{p_start + j:06d}", th[j, : counts[j]])
        overflow += int(over)

    # batch k + 1 is launched before batch k is read back and stored, so the
    # host store overlaps the card's work; the last partial batch generates
    # a whole batch and stores its first n tracks
    pending = None
    t0 = time.perf_counter()
    while start < args.tracks and time.time() < deadline:
        n = min(args.batch, args.tracks - start)
        out = ingest_hashes(tracks(np.arange(start, start + args.batch)))
        if pending is not None:
            drain(pending)
        pending = (start, n, out)
        start += n
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        batch_times.append(round(dt, 3))
        if len(batch_times) % 20 == 0 or start >= args.tracks:
            print(
                f"ingested {start}/{args.tracks} ({args.batch / dt:.1f} tracks/s "
                f"last batch, {ht.totalhashes()} hashes)",
                flush=True,
            )
    if pending is not None:
        drain(pending)
    ht.save(path, compress=False)
    state.update(
        next_track=start,
        ingest_batch_seconds=batch_times[-200:],
        hash_overflow=overflow,
        tracks_target=args.tracks,
    )
    if start >= args.tracks:
        steady = np.median(batch_times[5:]) if len(batch_times) > 5 else None
        state.update(
            ingest_done=True,
            **table_statistics(ht),
            ingest_tracks_per_sec=round(args.batch / steady, 1) if steady else None,
        )
        shown = {k: v for k, v in state.items() if k != "ingest_batch_seconds"}
        print("ingest complete:", json.dumps(shown, indent=2), flush=True)
    save_state(args.workdir, state)


_BANK_CACHE: dict = {}


def banks(kind: str, hours: float, device: torch.device):
    """The degradation banks, built once per process: ``dcase`` has the
    paper's corpus shape (15 noise scenes over ``hours`` of audio, 271
    impulse responses), ``toy`` 32 noise rows and 16 responses."""
    key = (kind, round(hours, 3), str(device))
    if key not in _BANK_CACHE:
        if kind == "dcase":
            _BANK_CACHE[key] = dcase_shaped_banks(
                sample_rate=SR, noise_row_length=QUERY_SECONDS * SR, hours=hours,
                num_scenes=15, num_irs=271, seed=7, device=device,
            )
        else:
            _BANK_CACHE[key] = synthetic_banks(
                sample_rate=SR, noise_row_length=QUERY_SECONDS * SR,
                num_noise=32, num_irs=16, device=device,
            )
    return _BANK_CACHE[key]


def condition_augmenter(params, args):
    """The frozen-seed(42) augmenter of one condition on ``args.device``."""
    dev = resolve_device(args.device)
    noise_bank, ir_bank = banks(args.banks, args.bank_hours, dev)
    fp = AugmentFP(noise_bank, SR, parameters=params, impulse_response_dir=ir_bank, device=dev)
    fp.freeze_parameters(42)
    return fp


def condition_batches(tracks: Tracks, fp, qidx, offsets, batch: int):
    """(start, track ids, crops) of each batch of one condition's queries:
    the clean crops, augmented by ``fp`` (None: clean) with query ``i``'s
    draws keyed by ``i``."""
    for s in range(0, len(qidx), batch):
        tids = qidx[s : s + batch]
        crops = make_queries(tracks, tids, offsets[s : s + batch])
        if fp is not None:
            crops = fp.batch_augment_indexed(
                crops[:, None, :], np.arange(s, s + len(tids))
            )[:, 0, :]
        yield s, tids, crops


def stage_train(args) -> None:
    """Train the denoiser that ``match --denoise`` uses on synthetic clean
    batches (3 s, seeds 11 / 12), the match conditions' banks degrading each
    step on the card; lr 1e-3, 4 validation batches, ``--train-epochs`` of
    ``--train-steps``. Saves ``workdir/{unet,demucs}.pt``."""
    dev = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    noise_bank, ir_bank = banks(args.banks, args.bank_hours, dev)
    augmenter = AugmentFP(noise_bank, SR, impulse_response_dir=ir_bank, device=dev)
    # the Trainer gives the model the JAX trainer's starting weights
    if args.model == "unet":
        model, input_type = UNet(1, 1, rate=0.05), "spec"
    else:
        model, input_type = Demucs(), "audio"
    t0 = time.time()
    with tempfile.TemporaryDirectory() as ckpt:
        trainer = Trainer(
            model=model,
            train_iter=synthetic_clean_batches(args.train_batch, 3 * SR, SR, seed=11),
            train_steps=args.train_steps,
            val_iter=synthetic_clean_batches(args.train_batch, 3 * SR, SR, seed=12),
            val_steps=4,
            learning_rate=1e-3,
            nb_epochs=args.train_epochs + 1,
            checkpoint=ckpt,
            input_type=input_type,
            augmenter=augmenter,
            example_batch=next(synthetic_clean_batches(args.train_batch, 3 * SR, SR)),
            device=dev,
        )
        trainer.start_epoch()
        trainer.training_loop()
        losses = [float(h["val"]["loss"]) for h in trainer.history]
    torch.save({"model": trainer.model.state_dict()},
               os.path.join(args.workdir, f"{args.model}.pt"))
    state = load_state(args.workdir)
    key = "denoiser_train" if args.model == "unet" else "denoiser_train_demucs"
    state[key] = {
        "model": args.model,
        "epochs": args.train_epochs,
        "steps_per_epoch": args.train_steps,
        "batch": args.train_batch,
        "banks": args.banks,
        "val_loss": [round(x, 5) for x in losses],
        "train_seconds": round(time.time() - t0, 1),
    }
    save_state(args.workdir, state)
    print("trained denoiser:", json.dumps(state[key]), flush=True)


def load_unet(path: str, device: torch.device, bf16: bool = False):
    """The spectrogram-denoiser hook of a checkpoint written by ``train``:
    (B, F, C) normalised magnitudes in, float32 out; ``bf16`` computes the
    UNet's body in bfloat16 (parameters stay float32)."""
    model = UNet(1, 1, rate=0.05, dtype=torch.bfloat16 if bf16 else None)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["model"])
    return unet_denoiser(model.to(device))


def load_demucs(path: str, device: torch.device, bf16: bool = False):
    """The waveform-denoiser hook ``(B, T) -> (B, T)`` of a Demucs
    checkpoint written by ``train --model demucs``; it runs ahead of the
    matcher, on the query waveforms."""
    model = Demucs(dtype=torch.bfloat16 if bf16 else None)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True)["model"])
    return demucs_denoiser(model.to(device))


def score_batch(verdicts, verd_den, tids, den_active: bool):
    """(correct, correct denoised, correct mix) of one batch. The mix rule
    takes the verdict with more aligned hashes, the undenoised one on a
    tie."""
    correct = correct_den = correct_mix = 0
    for v, vd, tid in zip(verdicts, verd_den, tids):
        gt = f"t{int(tid):06d}"
        if v[0] == "MATCH" and v[1] == gt:
            correct += 1
        if den_active:
            if vd[0] == "MATCH" and vd[1] == gt:
                correct_den += 1
            best = v if v[2] >= vd[2] else vd
            if best[0] == "MATCH" and best[1] == gt:
                correct_mix += 1
    return correct, correct_den, correct_mix


def stage_match(args, tracks: Optional[Tracks] = None) -> None:
    dev = resolve_device(args.device)
    state = load_state(args.workdir)
    require_ingest(state)
    ht = HashTable(_table_path(args.workdir))
    tracks = tracks or corpus_tracks(args.corpus_seed, dev)

    t0 = time.perf_counter()
    dm = DeviceMatcher(ht, device=dev)
    sync(dev)
    upload_s = time.perf_counter() - t0
    table_mb = dm._table.numel() * 4 / 1e6
    print(f"matcher ready: eff_depth={dm.eff_depth} table={table_mb:.0f}MB "
          f"upload+prep {upload_s:.1f}s", flush=True)

    qidx, offsets = query_plan(state["tracks_target"], args.queries, 42)
    conditions = select_conditions(args.conditions)

    # --denoise-model unet: the spectrogram hook inside the match;
    # demucs: the query waveforms denoised ahead of it. Demucs and bfloat16
    # reruns land under suffixed keys beside the earlier columns.
    denoiser = wave_den = None
    if args.denoise:
        if args.denoise_model == "demucs":
            wave_den = load_demucs(os.path.join(args.workdir, "demucs.pt"), dev, args.denoise_bf16)
        else:
            denoiser = load_unet(os.path.join(args.workdir, "unet.pt"), dev, args.denoise_bf16)
    den_active = args.denoise
    den_sfx = ""
    if den_active:
        den_sfx = ("_demucs" if args.denoise_model == "demucs" else "") + (
            "_bf16" if args.denoise_bf16 else ""
        )

    # one call of each path before the timed ones: cuFFT plans, the
    # allocator's pool, cuDNN's algorithm choice
    warm = make_queries(tracks, qidx[: args.batch], offsets[: args.batch])
    dm.match_waveforms(warm, shifts=args.shifts)
    if denoiser is not None:
        dm.match_waveforms(warm, shifts=args.shifts, denoiser=denoiser)
    if wave_den is not None:
        dm.match_waveforms(wave_den(warm), shifts=args.shifts)

    results = state.get("conditions", {})
    for cond, params in conditions.items():
        done_key = ("accuracy_den" + den_sfx) if den_active else "accuracy"
        if cond in results and done_key in results[cond] and not args.rerun:
            continue
        fp = condition_augmenter(params, args) if params is not None else None
        correct = correct_den = correct_mix = n_done = 0
        match_s = match_den_s = 0.0
        t_cond = time.perf_counter()
        for _, tids, crops in condition_batches(tracks, fp, qidx, offsets, args.batch):
            sync(dev)  # the match timer excludes the augmentation
            t0 = time.perf_counter()
            verdicts = dm.match_waveforms(crops, shifts=args.shifts)
            match_s += time.perf_counter() - t0
            if denoiser is not None:
                t0 = time.perf_counter()
                verd_den = dm.match_waveforms(crops, shifts=args.shifts, denoiser=denoiser)
                match_den_s += time.perf_counter() - t0
            elif wave_den is not None:
                # the Demucs pass is part of the denoised arm's cost
                t0 = time.perf_counter()
                verd_den = dm.match_waveforms(wave_den(crops), shifts=args.shifts)
                match_den_s += time.perf_counter() - t0
            else:
                verd_den = verdicts
            c, cd, cm = score_batch(verdicts, verd_den, tids, den_active)
            correct, correct_den, correct_mix = correct + c, correct_den + cd, correct_mix + cm
            n_done += len(tids)
        results[cond] = {
            **results.get(cond, {}),
            "accuracy": round(correct / max(n_done, 1), 4),
            "n_queries": n_done,
            "match_qps": round(n_done / match_s, 1),
            "wall_s": round(time.perf_counter() - t_cond, 1),
        }
        if den_active:
            results[cond].update({
                "accuracy_den" + den_sfx: round(correct_den / max(n_done, 1), 4),
                "accuracy_mix" + den_sfx: round(correct_mix / max(n_done, 1), 4),
                "match_den" + den_sfx + "_qps": round(n_done / match_den_s, 1),
            })
        print(cond, results[cond], flush=True)
        state["conditions"] = results
        state.update(
            eff_depth=int(dm.eff_depth),
            table_mb=round(table_mb, 1),
            table_upload_s=round(upload_s, 1),
            match_batch=args.batch,
            match_shifts=args.shifts,
            match_banks=args.banks,
            match_denoise=bool(den_active),
        )
        if den_active:
            state["match_denoise_model"] = args.denoise_model
        save_state(args.workdir, state)


def stage_peaks(args, tracks: Optional[Tracks] = None) -> None:
    """Peak P/R/F1 and spectrogram PSNR over the crops that ``match``
    identifies, each against its clean crop: masks from
    ``find_peaks_batch``, spectrograms from ``spectrogram_frontend``, with
    (``--denoise``) and without the UNet hook; sums kept on the card."""
    dev = resolve_device(args.device)
    state = load_state(args.workdir)
    require_ingest(state)
    tracks = tracks or corpus_tracks(args.corpus_seed, dev)
    denoiser = (
        load_unet(os.path.join(args.workdir, "unet.pt"), dev, args.denoise_bf16)
        if args.denoise else None
    )
    qidx, offsets = query_plan(state["tracks_target"], args.queries, 42)
    conditions = select_conditions(args.conditions, with_cleans=False)

    def masks_sgrams(wavs, hook):
        return find_peaks_batch(wavs, denoiser=hook), spectrogram_frontend(wavs, 512, 256, hook)

    def score(m_pred, m_clean, sg_pred, sg_clean):
        pm = batch_peak_metrics(m_pred, m_clean, reduce=False)
        return torch.stack([pm["precision"].sum(), pm["recall"].sum(), pm["f1"].sum(),
                            batch_psnr(sg_pred, sg_clean).sum()])

    results = state.get("conditions", {})
    for cond, params in conditions.items():
        if "peaks_f1" in results.get(cond, {}) and not args.rerun:
            continue
        fp = condition_augmenter(params, args)
        sums = torch.zeros(4, dtype=torch.float64, device=dev)
        sums_den = torch.zeros(4, dtype=torch.float64, device=dev)
        n_done = 0
        t_cond = time.perf_counter()
        for s in range(0, args.queries, args.batch):
            tids = qidx[s : s + args.batch]
            cleans = make_queries(tracks, tids, offsets[s : s + args.batch])
            aug = fp.batch_augment_indexed(cleans[:, None, :], np.arange(s, s + len(tids)))[:, 0, :]
            m_clean, sg_clean = masks_sgrams(cleans, None)
            m_aug, sg_aug = masks_sgrams(aug, None)
            sums += score(m_aug, m_clean, sg_aug, sg_clean)
            if denoiser is not None:
                m_den, sg_den = masks_sgrams(aug, denoiser)
                sums_den += score(m_den, m_clean, sg_den, sg_clean)
            n_done += len(tids)
        names = ("peaks_precision", "peaks_recall", "peaks_f1", "psnr_spec")
        cols = {k: round(float(x) / n_done, 4) for k, x in zip(names, sums.cpu())}
        if denoiser is not None:
            cols.update({k + "_den": round(float(x) / n_done, 4) for k, x in zip(names, sums_den.cpu())})
        cols["peaks_n_queries"] = n_done
        cols["peaks_wall_s"] = round(time.perf_counter() - t_cond, 1)
        results[cond] = {**results.get(cond, {}), **cols}
        print(cond, cols, flush=True)
        state["conditions"] = results
        save_state(args.workdir, state)


def stage_oracle(args, tracks: Optional[Tracks] = None) -> None:
    """``--oracle-n`` ``default_parameters`` queries (plan seed 43): the
    device matcher's verdicts on their hashes against the numpy
    ``Matcher``'s at full depth."""
    dev = resolve_device(args.device)
    state = load_state(args.workdir)
    require_ingest(state)
    ht = HashTable(_table_path(args.workdir))
    dm = DeviceMatcher(ht, device=dev)
    tracks = tracks or corpus_tracks(args.corpus_seed, dev)
    n = args.oracle_n
    qidx, offsets = query_plan(state["tracks_target"], n, 43)
    fp = condition_augmenter(test_pipelines_parameters["default_parameters"], args)
    aug = fp.batch_augment_indexed(
        make_queries(tracks, qidx, offsets)[:, None, :], np.arange(n)
    )[:, 0, :]
    hashes = AudfprintPeaks(afp_settings["audfprint"], device=dev).hashes_batch(aug, shifts=args.shifts)
    device_verdicts = dm.match_hashes_batch(hashes)
    oracle = Matcher()
    agree = 0
    for i in range(n):
        ov = oracle.hashes_match_to_msgs(ht, hashes[i])
        dv = device_verdicts[i]
        same = ov[0] == dv[0] and (ov[0] != "MATCH" or ov[1] == dv[1])
        agree += int(same)
        if not same:
            print("DISAGREE", i, "oracle:", ov, "device:", dv, flush=True)
    state["oracle_agreement"] = f"{agree}/{n}"
    state["oracle_shifts"] = args.shifts
    save_state(args.workdir, state)
    print("oracle agreement:", agree, "/", n, flush=True)


def write_report(workdir: str, out: Optional[str], name: str) -> dict:
    """The state without the per-batch times, as JSON at ``out`` (default
    ``<workdir>/<name>``)."""
    state = load_state(workdir)
    state.pop("ingest_batch_seconds", None)
    out = out or os.path.join(workdir, name)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(state, f, indent=2)
        f.write("\n")
    print(json.dumps(state, indent=2))
    print("wrote", out)
    return state


def stage_report(args) -> None:
    write_report(args.workdir, args.out, "results.json")


def default_workdir(name: str) -> str:
    return os.path.join(tempfile.gettempdir(), name)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("stage", choices=["ingest", "train", "match", "peaks", "oracle", "report"])
    p.add_argument("--workdir", default=default_workdir("scale_proof"))
    p.add_argument("--out", default=None, help="report file (default <workdir>/results.json)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--tracks", type=int, default=106574)  # |FMA-large|
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--minutes", type=float, default=8.0)
    p.add_argument("--shifts", type=int, default=1)
    p.add_argument("--conditions", default="all")
    p.add_argument("--corpus-seed", type=int, default=1234)
    p.add_argument("--oracle-n", type=int, default=32)
    p.add_argument("--rerun", action="store_true")
    p.add_argument("--banks", choices=["toy", "dcase"], default="toy")
    p.add_argument("--bank-hours", type=float, default=3.0)
    p.add_argument("--denoise", action="store_true",
                   help="also run the denoised analyzer and the mix rule (train first)")
    p.add_argument("--model", choices=["unet", "demucs"], default="unet",
                   help="which denoiser the train stage fits")
    p.add_argument("--denoise-model", choices=["unet", "demucs"], default="unet",
                   help="unet: spectrogram hook inside the match; demucs: waveform "
                        "denoiser ahead of it, columns under *_demucs keys")
    p.add_argument("--denoise-bf16", action="store_true",
                   help="UNet or Demucs inference in bfloat16, columns under *_bf16 keys")
    p.add_argument("--train-epochs", type=int, default=20)
    p.add_argument("--train-steps", type=int, default=16)
    p.add_argument("--train-batch", type=int, default=32)
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser().parse_args(argv)
    resolve_device(args.device)  # CUDA unless --device cpu; raises without it
    dict(
        ingest=stage_ingest, train=stage_train, match=stage_match,
        peaks=stage_peaks, oracle=stage_oracle, report=stage_report,
    )[args.stage](args)


if __name__ == "__main__":
    main()

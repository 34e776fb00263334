"""The plain reference of an identification batch, and the comparison that
decides ``correct`` in the identify cells.

For each sampled query the reference computes, from the same degraded
waveform and the same weights: the denoiser's output (on each shift's
normalised magnitudes or on the waveform, as the kind's ``DOMAIN`` says),
every shift's peak masks (the frontends and both prunes as plain loops),
the landmark hashes of all shifts deduplicated, and the verdict of the
numpy matcher over the hash table. The program's table is the one state the reference cannot rebuild
in a run (10,000 tracks, the reservoir's draws in ingest order), so the
reference reads it, and checks by itself the stage it skips: every table
entry of each sampled query's track and of each track a verdict names is
recomputed from that track's waveform.

Precisions: ``strict`` is the configuration's float32 with TF32 off;
``tf32`` lets the model use TF32 where its kind's ``tf32`` says (cuDNN's
convolutions and LSTM for the UNet and Demucs; the control of a cell with
a model); ``bf16_spectrogram`` rounds every spectrogram to bfloat16 before
the prunes (the control of a cell without one).
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import inputs as I

PRECISIONS = ("strict", "tf32", "bf16_spectrogram")


@contextlib.contextmanager
def precision_of(config: dict, precision: str):
    """The reference model's precision context: under ``tf32`` the kind's
    control (``kinds/<model>.py``'s ``tf32``) lets TF32 through."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, not {precision!r}")
    if precision != "tf32":
        yield
        return
    with I.kind(config).tf32():
        yield


def reference_denoiser(config: dict, device: str, weights: Dict[str, torch.Tensor]):
    """The configuration's model from the frozen modules with ``weights``,
    in evaluation, and its hook: (B, F, C) magnitudes or (B, T) waveforms
    to the same shape."""
    model = I.reference_model(config, device="cpu")
    model.load_state_dict({k: v.cpu() for k, v in weights.items()})
    model = model.to(device).eval()

    def hook(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(x).to(torch.float32)

    return model, hook


def hashes_of_masks(masks_by_shift: Sequence[torch.Tensor], maxpksperframe: int) -> List[np.ndarray]:
    """Each row's (time, hash) rows over all shifts, deduplicated and
    sorted."""
    from portbench.ref.afp import landmarks as lm

    per_shift = []
    for masks in masks_by_shift:
        C = int(masks.shape[-1])
        max_peaks = -(-maxpksperframe * C // 128) * 128
        th, valid = lm.hashes_from_masks_batched(masks, max_peaks=max_peaks,
                                                 max_hashes=max_peaks * lm.MAXPAIRSPERPEAK)
        th, valid = th.cpu().numpy(), valid.cpu().numpy()
        per_shift.append([t[v] for t, v in zip(th, valid)])
    return [I.unique_rows(np.concatenate([s[b] for s in per_shift], axis=0))
            for b in range(len(per_shift[0]))]


def reference_table(table, counts, names, hashesperid, hashbits, depth, maxtimebits):
    """The frozen host table class over the table's arrays (read only)."""
    from portbench.ref.afp.hash_table import HashTable

    ht = HashTable.__new__(HashTable)
    ht.set_arrays(table, counts, names, hashesperid, [hashbits, depth, maxtimebits, 0])
    ht._rng = None
    return ht


def reference_outputs(config: dict, waves: torch.Tensor, arm: str, hook, table,
                      precision: str) -> dict:
    """One arm's reference over (S, T) waveforms: the denoiser's outputs
    (shift by shift for a spectrogram model), the masks of every shift,
    the hashes and the verdicts."""
    from portbench.ref.afp.matcher import Matcher
    from portbench.ref.afp.peaks import find_peaks_shifts

    s = config["audfprint"]
    seen: List[torch.Tensor] = []
    spec_hook, x = None, waves
    with precision_of(config, precision):
        if arm == "denoised" and I.kind(config).DOMAIN == "waveform":
            x = hook(waves)
            seen.append(x)
        elif arm == "denoised":
            def spec_hook(sgram):
                out = hook(sgram)
                seen.append(out)
                return out
        if precision == "bf16_spectrogram":
            inner = spec_hook

            def spec_hook(sgram):
                sgram = sgram if inner is None else inner(sgram)
                return sgram.to(torch.bfloat16).to(torch.float32)

        masks = find_peaks_shifts(x, s["shifts"], density=s["density"], n_fft=s["n_fft"],
                                  n_hop=s["n_hop"], f_sd=s["freq-sd"],
                                  maxpksperframe=s["pks-per-frame"], denoiser=spec_hook)
    hashes = hashes_of_masks(masks, s["pks-per-frame"])
    matcher = Matcher()
    verdicts = [best_verdict(matcher, table, h) for h in hashes]
    return {"den": [d.float() for d in seen], "masks": list(masks), "hashes": hashes,
            "verdicts": verdicts}


def best_verdict(matcher, table, hashes: np.ndarray) -> tuple:
    """("MATCH", the names of every track with the best aligned count, that
    count) or ("NOMATCH", (), 0): the matcher's verdict with its ties, which
    its sort leaves in no set order."""
    rows, _ = matcher.match_hashes(table, hashes)
    if len(rows) == 0:
        return ("NOMATCH", (), 0)
    best = int(rows[:, 1].max())
    return ("MATCH", tuple(sorted(str(table.names[i]) for i in rows[rows[:, 1] == best, 0])), best)


def same_verdict(got: tuple, want: tuple) -> bool:
    """A verdict (status, name, aligned count) against the reference's
    (status, tied best names, count)."""
    if tuple(got[:1]) != tuple(want[:1]) or int(got[2]) != int(want[2]):
        return False
    if want[0] != "MATCH":
        return True
    names = want[1] if isinstance(want[1], tuple) else (want[1],)
    got_names = got[1] if isinstance(got[1], tuple) else (got[1],)
    return bool(set(got_names) & set(names))


def compare(prog: dict, ref: dict, arm: str) -> Dict[str, float]:
    """The numbers compared for one arm: the denoiser's largest gap over
    the reference's largest magnitude, the mask cells that differ, the
    hash rows in one set and not the other, the verdicts that differ in
    status, track or aligned count."""
    out = {}
    if ref["den"]:
        top = max(float(d.abs().max()) for d in ref["den"])
        gap = max(float((p.to(r.device) - r).abs().max()) for p, r in zip(prog["den"], ref["den"]))
        out[f"den_rel.{arm}"] = gap / max(top, 1e-30)
    out[f"mask_cells.{arm}"] = float(sum(int((p.to(r.device) != r).sum())
                                         for p, r in zip(prog["masks"], ref["masks"])))
    out[f"hash_rows.{arm}"] = float(sum(I.row_set_difference(p, r)
                                        for p, r in zip(prog["hashes"], ref["hashes"])))
    wrong = [(p, r) for p, r in zip(prog["verdicts"], ref["verdicts"]) if not same_verdict(p, r)]
    for p, r in wrong[:4]:
        print(f"portbench: {arm} verdict {p} against the reference's {r}", file=sys.stderr)
    out[f"verdicts.{arm}"] = float(len(wrong))
    return out


def track_hashes(config: dict, waves: torch.Tensor) -> List[np.ndarray]:
    """The reference's ingest of whole tracks: one shift, as the index is
    built."""
    from portbench.ref.afp.peaks import find_peaks_batch

    s = config["audfprint"]
    masks = find_peaks_batch(waves, density=s["density"], n_fft=s["n_fft"], n_hop=s["n_hop"],
                             f_sd=s["freq-sd"], maxpksperframe=s["pks-per-frame"])
    return hashes_of_masks([masks], s["pks-per-frame"])


def table_faults(table, track_ids: Sequence[int], hashes: Sequence[np.ndarray],
                 device: str) -> int:
    """Entries of the given tracks that the table holds anywhere and the
    reference's hashes do not give, plus those it should hold and lacks: a
    bucket that never overflowed holds every row offered to it, one that
    did holds a subset."""
    hb = (1 << table.hashbits) - 1
    tbits = table.maxtimebits
    tmask = (1 << tbits) - 1
    # every (hash, time, id) the table holds for these tracks, found on the
    # device in one pass over the table
    tab = torch.from_numpy(table.table.view(np.int32)).to(device)
    cnt = torch.from_numpy(np.minimum(table.counts, table.depth).astype(np.int64)).to(device)
    live = torch.arange(tab.shape[1], device=device)[None, :] < cnt[:, None]
    ids = (tab >> tbits) - 1
    hit = live & torch.isin(ids, torch.as_tensor(list(track_ids), device=device, dtype=ids.dtype))
    h_idx, s_idx = torch.nonzero(hit, as_tuple=True)
    vals = tab[h_idx, s_idx]
    held = {(int(i), int(h), int(t)) for i, h, t in zip(
        ((vals >> tbits) - 1).tolist(), h_idx.tolist(), (vals & tmask).tolist())}
    del tab, cnt, live, ids, hit
    want = {(int(tid), int(h) & hb, int(t) & tmask)
            for tid, rows in zip(track_ids, hashes) for t, h in rows}
    spurious = len(held - want)
    missing = sum(1 for key in want - held if int(table.counts[key[1]]) <= table.depth)
    return spurious + missing

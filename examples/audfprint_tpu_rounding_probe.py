"""Does TPU rounding in the prune explain audfprint's scale-proof gap?

At 106,574 tracks the port's audfprint table (largest bucket 2,305 offered
hashes) differs from the JAX package's TPU artifact (1,106), while Dejavu,
on the same corpus and queries, agrees with it. Two pieces of arithmetic lie
on audfprint's path alone and run only on the TPU: the one-hot Gaussian
gather of the Pallas prunes on the matrix unit (``peaks_pallas.py``), and
the matrix-unit FFT of ``log_hpf_frontend``. Neither runs on the CPU.

This probe hashes the first ``--tracks`` tracks of the scale corpus
(``--corpus-seed`` 1234, 30 s at 8 kHz) on the CPU four ways:

- ``jax``: the JAX package's scan prune as it stands;
- ``jax_bf16_gauss``: the same with the Gaussian table rounded to bfloat16,
  what a single-pass matrix-unit product of the table would use if the
  f32 operands were rounded (``peaks._gauss_table_np`` is patched in this
  process only);
- ``port_jax_waves``: the port's ``ingest_hashes`` on JAX's waveforms;
- ``port``: the port on its own corpus, as its scale proof runs.

For each it prints the hashes stored per track, the most frequent hash
value and how many tracks' rows hold it, and the peak-mask cells and hash
rows that differ from ``jax``; one JSON object at the end.

    JAX_PLATFORMS=cpu python examples/audfprint_tpu_rounding_probe.py --tracks 512
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

SR = 8000
TRACK_SECONDS = 30
HCAP = 4096

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _jax_program(bf16_gauss: bool):
    """tracks -> (masks, (B, HCAP, 2) rows, (B,) counts) in the JAX package,
    the scale proof's ingest program without the corpus."""
    from musicfpaugment_tpu.afp.audfprint import landmarks as lm
    from musicfpaugment_tpu.afp.audfprint import peaks

    def prog(wavs):
        masks = peaks.find_peaks_batch(wavs, use_pallas=False)
        C = int(masks.shape[-1])
        max_peaks = -(-5 * C // 128) * 128
        th, v = lm.hashes_from_masks_batched(
            masks, max_peaks=max_peaks, max_hashes=max_peaks * lm.MAXPAIRSPERPEAK)
        t, h, v = lm.sort_dedup_hashes(th[..., 0], th[..., 1], v)
        t, h, n = lm.compact_valid_first(t, h, v, out_len=HCAP)
        return masks, jnp.stack([t, h], axis=-1), jnp.minimum(n, HCAP)

    table = peaks._gauss_table_np
    if not bf16_gauss:
        return jax.jit(prog)

    def rounded(npts, width):
        return table(npts, width).astype(jnp.bfloat16).astype(np.float32)

    def patched(wavs):
        peaks._gauss_table_np = rounded
        try:
            return prog(wavs)
        finally:
            peaks._gauss_table_np = table

    return jax.jit(patched)


def _port_program():
    from musicfpaugment_torch.afp.audfprint.peaks import find_peaks_batch
    from musicfpaugment_torch.testing.scale_proof import ingest_hashes

    def prog(wavs):
        with torch.no_grad():
            rows, n, _ = ingest_hashes(wavs)
            return find_peaks_batch(wavs).numpy(), rows.numpy(), n.numpy()

    return prog


def _summary(rows, counts):
    """hashes per track, the most frequent hash and the tracks holding it."""
    valid = [r[:c, 1] for r, c in zip(rows, counts)]
    per_track = np.unique(np.concatenate([np.unique(v) for v in valid]), return_counts=True)
    top = int(np.argmax(per_track[1]))
    return {
        "hashes_per_track": float(np.mean(counts)),
        "total_hashes": int(np.sum(counts)),
        "most_frequent_hash": int(per_track[0][top]),
        "tracks_holding_it": int(per_track[1][top]),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tracks", type=int, default=512)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--corpus-seed", type=int, default=1234)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)

    from musicfpaugment_torch.data.synthetic import synth_tracks_device as port_tracks
    from musicfpaugment_tpu.data.synthetic import synth_tracks_device

    corpus_key = jax.random.PRNGKey(args.corpus_seed)
    jax_waves = jax.jit(lambda idx: synth_tracks_device(corpus_key, idx, TRACK_SECONDS * SR, SR))
    runs = {"jax": _jax_program(False), "jax_bf16_gauss": _jax_program(True)}
    port = _port_program()
    names = list(runs) + ["port_jax_waves", "port"]
    rows = {n: [] for n in names}
    counts = {n: [] for n in names}
    mask_diff = {n: 0 for n in names}
    row_diff = {n: 0 for n in names}
    wave_err = 0.0
    cells = 0
    t0 = time.time()
    for lo in range(0, args.tracks, args.batch):
        idx = np.arange(lo, min(lo + args.batch, args.tracks), dtype=np.int32)
        waves = np.asarray(jax_waves(jnp.asarray(idx)))
        own = port_tracks(args.corpus_seed, idx, TRACK_SECONDS * SR, SR, device="cpu")
        wave_err = max(wave_err, float(np.abs(own.numpy() - waves).max()))
        out = {n: tuple(np.asarray(a) for a in f(jnp.asarray(waves))) for n, f in runs.items()}
        out["port_jax_waves"] = port(torch.from_numpy(np.array(waves)))
        out["port"] = port(own)
        ref_mask, ref_rows, ref_n = out["jax"]
        cells += ref_mask.size
        for n in names:
            mask, r, c = out[n]
            mask_diff[n] += int(np.sum(mask != ref_mask))
            row_diff[n] += int(sum(
                len(set(map(tuple, r[b, :c[b]])) ^ set(map(tuple, ref_rows[b, :ref_n[b]])))
                for b in range(len(idx))))
            rows[n].extend(r)
            counts[n].extend(c)
        print(f"{idx[-1] + 1} tracks, {time.time() - t0:.0f} s", flush=True)

    result = {"tracks": args.tracks, "corpus_seed": args.corpus_seed, "mask_cells": cells,
              "port_corpus_max_abs_diff_from_jax": wave_err}
    for n in names:
        result[n] = dict(_summary(rows[n], counts[n]), mask_cells_differing=mask_diff[n],
                         hash_rows_differing=row_diff[n])
        print(n, json.dumps(result[n]))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

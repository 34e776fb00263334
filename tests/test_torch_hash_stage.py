"""The matcher's hashing stage: every shift's peak masks to the compacted,
deduplicated union of their (time, hash) pairs.

On the CPU, ``landmarks.union_hashes_plain`` (and the ``union_hashes``
dispatch to it) against the per-shift chain of ``hashes_from_masks_batched``,
``sort_dedup_hashes`` and ``compact_valid_first`` bit for bit, padding and
``n_valid`` included, and against a numpy set reference. On the card
(``cuda`` marker, skipped without one), the kernel of ``hashes_cuda.py``
against the plain function bit for bit, and the analyzer's ``hashes_batch``
(one launch a call) against the same call on the CPU. The file imports no
JAX, so it runs on the card:

    python -m pytest tests/test_torch_hash_stage.py --noconftest -q
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from musicfpaugment_torch.afp.audfprint import landmarks as lm
from torch_threads import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

MAXPKS = 5  # audfprint's maxpksperframe
QUERY_COLS = [251, 250, 250, 250]  # 8 s at hop 256, 4 shifts
LONG_COLS = [938, 937, 937, 937]  # 30 s


def _sparse(r, B, F, C, density, per_col=5):
    """Random masks with at most ``per_col`` peaks a column."""
    m = r.random((B, F, C)) < density
    return m & (np.cumsum(m, axis=1) <= per_col)


def _family(r, B, F, cols, density, per_col=5, flips=40):
    """The shifts of one batch: a base mask cut to each shift's columns,
    ``flips`` random cells toggled a query, so most pairs repeat across
    shifts as real shifts' do."""
    base = _sparse(r, B, F, max(cols), density, per_col)
    out = []
    for c in cols:
        m = base[:, :, :c].copy()
        for b in range(B):
            m[b, r.integers(0, F, flips), r.integers(0, c, flips)] ^= True
        out.append(m)
    return out


def stacked_masks(masks_np, device="cpu"):
    """S numpy (B, F, C_s) masks as ``peaks.find_peaks_parts`` returns them
    on the card: bool views of one time-major (S*B, max C, F) byte tensor,
    sliced to each shift's columns."""
    S, (B, F) = len(masks_np), masks_np[0].shape[:2]
    wide = max(m.shape[2] for m in masks_np)
    tm = np.zeros((S * B, wide, F), np.uint8)
    for s, m in enumerate(masks_np):
        tm[s * B : (s + 1) * B, : m.shape[2]] = m.transpose(0, 2, 1)
    view = torch.from_numpy(tm).to(device).view(torch.bool).transpose(1, 2)
    return [view[s * B : (s + 1) * B, :, : m.shape[2]] for s, m in enumerate(masks_np)]


def chain(masks, maxpks, budget):
    """The matcher's hashing stage as it was written before it became one
    function: per shift ``hashes_from_masks_batched``, then the cross-shift
    ``sort_dedup_hashes`` and ``compact_valid_first``."""
    th_parts, valid_parts = [], []
    for m in masks:
        max_peaks = -(-maxpks * int(m.shape[-1]) // 128) * 128
        th, v = lm.hashes_from_masks_batched(
            m, max_peaks=max_peaks, max_hashes=max_peaks * lm.MAXPAIRSPERPEAK
        )
        th_parts.append(th)
        valid_parts.append(v)
    th = torch.cat(th_parts, dim=1)
    valid = torch.cat(valid_parts, dim=1)
    t, h, v = lm.sort_dedup_hashes(th[..., 0], th[..., 1], valid)
    return lm.compact_valid_first(t, h, v, out_len=min(budget, t.shape[-1]))


def hashes_np(mask, max_peaks, window=320):
    """``landmarks.hashes_from_mask_np`` with the first ``max_peaks`` peaks
    kept and each peak's candidates limited to the next ``window`` peaks:
    (N, 2) unique sorted (time, hash) rows."""
    bins_f, cols_c = np.nonzero(mask)
    order = np.lexsort((bins_f, cols_c))[:max_peaks]
    cols_s, bins_s = cols_c[order].astype(int), bins_f[order].astype(int)
    out = set()
    for i in range(len(cols_s)):
        pairs = 0
        for j in range(i + 1, min(i + window, len(cols_s) - 1) + 1):
            dt = cols_s[j] - cols_s[i]
            if dt >= lm.TARGETDT:
                break
            df = bins_s[j] - bins_s[i]
            if dt >= lm.MINDT and abs(df) < lm.TARGETDF:
                out.add((cols_s[i], ((bins_s[i] & 255) << 12) | ((df & 63) << 6) | (dt & 63)))
                pairs += 1
                if pairs == lm.MAXPAIRSPERPEAK:
                    break
    return np.array(sorted(out), np.int64).reshape(-1, 2)


def union_np(masks_np, maxpks, budget):
    """The numpy set reference: the union over shifts of each query's
    ``hashes_np``, sorted, truncated at ``out_len``; with each query's
    count of distinct pairs."""
    max_peaks = [lm.shift_max_peaks(m.shape[2], maxpks) for m in masks_np]
    out_len = min(budget, lm.MAXPAIRSPERPEAK * sum(max_peaks))
    B = masks_np[0].shape[0]
    t = np.zeros((B, out_len), np.int32)
    h = np.zeros((B, out_len), np.int32)
    n = np.zeros(B, np.int64)
    for b in range(B):
        rows = np.unique(np.concatenate(
            [hashes_np(m[b], p) for m, p in zip(masks_np, max_peaks)]
        ), axis=0)
        n[b] = len(rows)
        keep = rows[:out_len]
        t[b, : len(keep)], h[b, : len(keep)] = keep[:, 0], keep[:, 1]
    return t, h, n


def _dense_pairs(r, masks, cols, n):
    """Columns ``cols`` and the next of every query of every shift get ``n``
    peaks: a peak there has more than 320 successors less than MINDT
    columns on, so the window ends its walk before it can pair."""
    for m in masks:
        for b in range(m.shape[0]):
            for c in cols:
                for cc in (c, c + 1):
                    m[b, r.choice(m.shape[1], n, replace=False), cc] = True
    return masks


def _case(kind, seed, B=3, cols=QUERY_COLS):
    """(numpy masks of each shift, budget) of one named case."""
    r = np.random.default_rng(seed)
    if kind == "one_shift":
        return [_sparse(r, B, 256, cols[0], 0.01)], 4096
    if kind == "query_shifts":
        return _family(r, B, 256, cols, 0.015), 4096
    if kind == "budget_below_union":
        return _family(r, B, 256, cols, 0.015), 96
    if kind == "empty_rows":  # query 1 has no peak in any shift, query 2 in shift 0 only
        masks = _family(r, B, 256, cols, 0.01)
        for s, m in enumerate(masks):
            m[1] = False
            if s:
                m[2] = False
        return masks, 4096
    if kind == "all_empty":
        return [np.zeros((B, 256, c), bool) for c in cols], 4096
    if kind == "peak_cap_binds":  # ~25 peaks a column: P = 1,280 is reached by column ~50
        return _family(r, B, 256, cols, 0.1, per_col=256, flips=200), 4096
    if kind == "window_binds":
        return _dense_pairs(r, _family(r, B, 256, cols, 0.004), (60, 150), 170), 4096
    if kind == "dense_columns":  # every 4th column holds up to 40 peaks, the rest up to 5
        masks = _family(r, B, 256, cols, 0.01)
        for m in masks:
            m[:, :, ::4] |= _sparse(r, B, 256, m.shape[2], 0.3, per_col=40)[:, :, ::4]
        return masks, 4096
    if kind == "narrow_bins":
        return _family(r, B, 64, [40, 39], 0.05, flips=10), 100000
    if kind == "many_shifts":  # 130 shifts of alternating widths
        return _family(r, B, 256, [cols[0] - s % 2 for s in range(130)], 0.004), 4096
    raise ValueError(kind)


CASES = [
    # kind, seed, whether the peak cap or the window binds
    ("one_shift", 0, False),
    ("query_shifts", 1, False),
    ("budget_below_union", 2, False),
    ("empty_rows", 3, False),
    ("all_empty", 4, False),
    ("peak_cap_binds", 5, True),
    ("window_binds", 6, True),
    ("dense_columns", 7, True),
    ("narrow_bins", 8, False),
    ("many_shifts", 9, False),
]


@pytest.mark.parametrize("kind,seed,binds", CASES, ids=[c[0] for c in CASES])
def test_union_hashes_plain_matches_chain_and_numpy(kind, seed, binds):
    masks_np, budget = _case(kind, seed)
    masks = stacked_masks(masks_np)
    got = lm.union_hashes_plain(masks, MAXPKS, budget)
    want = chain(masks, MAXPKS, budget)
    for g, w, dtype in zip(got, want, (torch.int32, torch.int32, torch.int64)):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, w)
    t, h, n = union_np(masks_np, MAXPKS, budget)
    np.testing.assert_array_equal(got[0].numpy(), t)
    np.testing.assert_array_equal(got[1].numpy(), h)
    np.testing.assert_array_equal(got[2].numpy(), n)
    if kind == "budget_below_union":
        assert (n > got[0].shape[1]).all()
    # the dispatch runs the plain chain on CPU tensors
    for g, w in zip(lm.union_hashes(masks, MAXPKS, budget), got):
        assert torch.equal(g, w)
    # without the caps, the reference is hashes_from_mask_np's own loop
    if not binds:
        for b in range(masks_np[0].shape[0]):
            rows = np.unique(np.concatenate(
                [lm.hashes_from_mask_np(m[b]).reshape(-1, 2) for m in masks_np]
            ), axis=0)
            assert len(rows) == n[b]
            kept = np.stack([t[b], h[b]], 1)[: len(rows)]
            np.testing.assert_array_equal(rows[: t.shape[1]], kept)


def test_caps_bind_in_their_cases():
    """The dense cases do reach the peak cap, the 320-peak window and
    columns of more than five peaks: without the cap or the window their
    pairs would differ."""
    unbounded = 10**9
    m = _case("peak_cap_binds", 5)[0][0][0]
    P = lm.shift_max_peaks(m.shape[1], MAXPKS)
    assert not np.array_equal(hashes_np(m, P), hashes_np(m, unbounded))
    m = _case("window_binds", 6)[0][0][0]
    assert m.sum() < P
    assert not np.array_equal(hashes_np(m, P), hashes_np(m, P, window=unbounded))
    m = _case("dense_columns", 7)[0][0][0]
    assert m.sum(axis=0).max() > 5


def test_kernel_constants_are_landmarks():
    """The pairing constants and the window that csrc/union_hashes.cu
    compiles in are landmarks.py's."""
    src = (Path(lm.__file__).parents[2] / "csrc" / "union_hashes.cu").read_text()
    got = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    window = inspect.signature(lm.hashes_from_masks_batched).parameters["window"].default
    want = {"kMaxPairs": lm.MAXPAIRSPERPEAK, "kMinDt": lm.MINDT, "kTargetDt": lm.TARGETDT,
            "kTargetDf": lm.TARGETDF, "kWindow": window}
    assert {k: got.get(k) for k in want} == want


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hashing kernel has no CPU mode")
    from musicfpaugment_torch.afp.audfprint import hashes_cuda

    hashes_cuda.reset_launch_counts()
    return torch.device("cuda")


def _kernel_vs_plain(masks, budget):
    from musicfpaugment_torch.afp.audfprint import hashes_cuda

    got = lm.union_hashes(masks, MAXPKS, budget)
    want = lm.union_hashes_plain(masks, MAXPKS, budget)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device
    rows = (got[0] != want[0]).any(1) | (got[1] != want[1]).any(1) | (got[2] != want[2])
    assert int(rows.sum()) == 0, f"{int(rows.sum())} of {rows.numel()} rows differ"
    return hashes_cuda.LAUNCHES["union_hashes"]


CUDA_CASES = [
    # kind of masks, columns of the shifts, batch, budget
    ("query_shifts", QUERY_COLS, 128, 4096),
    ("query_shifts", LONG_COLS, 128, 4096),
    ("query_shifts", LONG_COLS, 16, 60000),
    ("peak_cap_binds", QUERY_COLS, 16, 4096),
    ("peak_cap_binds", LONG_COLS, 16, 60000),
    ("window_binds", QUERY_COLS, 16, 4096),
    ("dense_columns", QUERY_COLS, 16, 4096),
    ("budget_below_union", QUERY_COLS, 16, 96),
    ("empty_rows", QUERY_COLS, 16, 4096),
    ("all_empty", QUERY_COLS, 16, 4096),
    ("one_shift", QUERY_COLS, 16, 4096),
    ("narrow_bins", QUERY_COLS, 16, 4096),
    ("many_shifts", QUERY_COLS, 4, 4096),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,cols,B,budget", CUDA_CASES,
    ids=[f"{k}-{c[0]}-{b}-{n}" for k, c, b, n in CUDA_CASES],
)
def test_kernel_matches_plain(cuda_device, kind, cols, B, budget):
    masks_np, _ = _case(kind, 100 + B, B=B, cols=cols)
    assert _kernel_vs_plain(stacked_masks(masks_np, cuda_device), budget) == 1


@pytest.mark.cuda
def test_kernel_on_prune_masks(cuda_device):
    """The masks the prunes give 128 8 s queries in 4 shifts, as the
    matcher hashes them."""
    from musicfpaugment_torch.afp.audfprint.peaks import find_peaks_shifts

    r = np.random.default_rng(11)
    t = np.arange(8 * 8000) / 8000
    waves = np.zeros((128, t.size), np.float32)
    for row in waves:
        for f in r.uniform(100, 3000, 12):
            phase = 2 * np.pi * f * r.uniform(0.99, 1.01) * t + r.uniform(0, 6)
            row += np.sin(phase).astype(np.float32)
        row *= (r.random(t.size) < 0.7).astype(np.float32)  # broadband bursts
    masks = find_peaks_shifts(torch.from_numpy(0.05 * waves).to(cuda_device), 4)
    assert [int(m.shape[-1]) for m in masks] == QUERY_COLS
    assert _kernel_vs_plain(masks, 4096) == 1


@pytest.mark.cuda
def test_kernel_launches_once_a_call_and_checks_its_inputs(cuda_device):
    from musicfpaugment_torch.afp.audfprint import hashes_cuda

    r = np.random.default_rng(12)
    masks_np = _family(r, 4, 256, QUERY_COLS, 0.01)
    masks = stacked_masks(masks_np, cuda_device)
    P = [lm.shift_max_peaks(c, MAXPKS) for c in QUERY_COLS]
    for k in range(3):
        hashes_cuda.union_hashes_cuda(masks, P, 4096)
        assert hashes_cuda.LAUNCHES["union_hashes"] == k + 1
    with pytest.raises(ValueError, match="CUDA tensors only"):
        hashes_cuda.union_hashes_cuda(stacked_masks(masks_np), P, 4096)
    with pytest.raises(ValueError, match="bool"):
        hashes_cuda.union_hashes_cuda([m.to(torch.uint8) for m in masks], P, 4096)
    with pytest.raises(ValueError, match="time-major"):
        hashes_cuda.union_hashes_cuda([m.contiguous() for m in masks], P, 4096)
    with pytest.raises(ValueError, match="multiple of 16"):
        odd = [np.zeros((4, 24, 250), bool)] * 4  # rows of 6,000 bytes: aligned, F is not
        hashes_cuda.union_hashes_cuda(stacked_masks(odd, cuda_device), P, 4096)
    assert hashes_cuda.LAUNCHES["union_hashes"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("shifts", [1, 4])
def test_hashes_batch_launches_once_and_equals_cpu(cuda_device, shifts, monkeypatch):
    """The analyzer's ``hashes_batch`` (the ingest's hashing) over a
    mixed-length batch with one silent row: one kernel launch a call, and
    the same call on the CPU, array for array. The CPU call is given the
    card's peak masks (the two devices' FFTs round apart in a few cells)."""
    from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, hashes_cuda
    from musicfpaugment_torch.afp.audfprint import analyzer as analyzer_mod
    from musicfpaugment_torch.afp.audfprint.analyzer import pad_waveform_batch
    from musicfpaugment_torch.testing.parameters import afp_settings

    r = np.random.default_rng(13)
    waves = []
    for seconds in (8.0, 3.5, 6.25, 2.0, 5.0):
        t = np.arange(int(seconds * 8000)) / 8000
        w = sum(np.sin(2 * np.pi * f * t + r.uniform(0, 6)) for f in r.uniform(100, 3000, 12))
        waves.append((0.05 * w * (r.random(t.size) < 0.7)).astype(np.float32))
    waves[3][:] = 0.0  # silent: no peaks, no hashes
    batch, valid = pad_waveform_batch(waves)
    card_masks = []
    prune = analyzer_mod.find_peaks_shifts

    def card_masks_everywhere(waveforms, n_shifts, **kw):
        if waveforms.is_cuda:
            card_masks[:] = prune(waveforms, n_shifts, **kw)
            return card_masks
        return [m.cpu() for m in card_masks]

    monkeypatch.setattr(analyzer_mod, "find_peaks_shifts", card_masks_everywhere)
    settings = afp_settings["audfprint"]
    card = AudfprintPeaks(settings, device=cuda_device)
    cpu = AudfprintPeaks(settings, device="cpu")
    got = card.hashes_batch(batch.to(cuda_device), shifts=shifts, valid_samples=valid)
    assert hashes_cuda.LAUNCHES["union_hashes"] == 1
    want = cpu.hashes_batch(batch, shifts=shifts, valid_samples=valid)
    assert len(card_masks) == shifts and len(got) == len(want) == len(waves)
    assert len(want[3]) == 0 and all(len(w) for i, w in enumerate(want) if i != 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)

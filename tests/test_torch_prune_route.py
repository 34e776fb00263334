"""The parts of the prune route around the CUDA kernels that run on the CPU:
the float-to-key argmax the kernels use (stated in numpy in ``peaks.py``), the
time-major frontend, the bool view of the kernels' byte masks, and the
stacking of a batch's time shifts into one prune, which must give what the
per-shift loop gives, bit for bit, with the plain prunes.
"""

import numpy as np
import pytest
import torch

from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.afp.audfprint import analyzer as analyzer_mod
from musicfpaugment_torch.afp.audfprint import matcher_device as matcher_mod
from musicfpaugment_torch.afp.audfprint import peaks as tp
from musicfpaugment_torch.afp.audfprint import peaks_cuda
from musicfpaugment_torch.afp.audfprint.analyzer import pad_waveform_batch
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.testing.parameters import afp_settings

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

SR = 8000
N_HOP = 256


# ------------------------------------------------------------ the key argmax


def _tricky_rows(seed, n, F):
    """float32 rows with what breaks an argmax by key: few levels (ties),
    negatives, both zeros, -inf, and rows that are all one value."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, F)).astype(np.float32)
    x[: n // 2] = np.round(x[: n // 2] * 2) / 2  # ties, and +0.0 / -0.0
    x[1] = -np.abs(x[1])  # all negative
    x[2] = np.where(r.random(F) < 0.5, np.float32(-0.0), np.float32(0.0))
    x[3] = -np.inf
    x[4] = np.where(r.random(F) < 0.7, -np.inf, x[4])
    x[5] = 1.25
    x[6, ::3] = -0.0
    x[6] = np.minimum(x[6], 0.0)  # maximum is a zero of either sign
    return x


@pytest.mark.parametrize("F", [32, 96, 256, 512])
def test_key_argmax_is_first_maximum(F):
    x = _tricky_rows(F, 64, F)
    pos, val = tp.argmax_by_key(x)
    want = torch.argmax(torch.from_numpy(x), dim=-1).numpy()
    np.testing.assert_array_equal(pos, want)
    # the value taken back from the key has the float's bits (+0.0 for -0.0)
    picked = x[np.arange(len(x)), want] + np.float32(0.0)
    np.testing.assert_array_equal(val.view(np.uint32), picked.view(np.uint32))


def test_key_order_is_float_order():
    r = np.random.default_rng(0)
    a = _tricky_rows(1, 32, 256).ravel()
    b = r.permutation(a)
    ka, kb = tp.float_order_key(a), tp.float_order_key(b)
    np.testing.assert_array_equal(ka < kb, a < b)
    np.testing.assert_array_equal(ka == kb, a == b)
    assert tp.float_order_key(np.float32(-np.inf)) == 0x007FFFFF
    assert (ka > 0).all()  # 0 stays free for "no candidate"
    back = tp.float_from_key(ka)
    np.testing.assert_array_equal(back.view(np.uint32), (a + np.float32(0)).view(np.uint32))


def test_positive_floats_order_by_their_bits():
    """The forward kernel's candidates are positive: it skips the key map."""
    r = np.random.default_rng(3)
    a = np.abs(_tricky_rows(2, 32, 256).ravel())
    a = a[(a > 0) & np.isfinite(a)]
    a = np.concatenate([a, np.float32([1e-45, 1e-38, 3.4e38, np.inf])]).astype(np.float32)
    b = r.permutation(a)
    np.testing.assert_array_equal(a.view(np.uint32) < b.view(np.uint32), a < b)
    np.testing.assert_array_equal(
        tp.float_order_key(a), a.view(np.uint32) | np.uint32(0x80000000)
    )


# ------------------------------------------------------------ the frontend


def _waves(seed, B, seconds):
    return next(synthetic_clean_batches(B, int(seconds * SR), seed=seed))


@pytest.mark.parametrize("with_valid", [False, True])
def test_time_major_frontend_equals_transposed(with_valid):
    x = torch.from_numpy(_waves(5, 3, 2.0))
    vf = torch.tensor([63, 40, 1], dtype=torch.int32) if with_valid else None
    want = tp.prune_input(x, valid_frames=vf)
    got = tp.prune_input(x, valid_frames=vf, time_major=True)
    assert got.is_contiguous() and got.shape == (3, want.shape[2], want.shape[1])
    assert torch.equal(got, want.transpose(1, 2))
    # into a strided slice of a wider batch, as the stacked route writes it
    B, C, F = got.shape
    wide = torch.zeros((2 * B, C + 2, F))
    ret = tp.prune_input(x, valid_frames=vf, time_major=True, out=wide[B:, :C])
    assert torch.equal(wide[B:, :C], got) and ret.data_ptr() == wide[B:, :C].data_ptr()
    assert not wide[:B].any() and not wide[:, C:].any()


def test_byte_masks_view_as_bool_masks():
    u8 = torch.from_numpy(
        (np.random.default_rng(2).random((3, 7, 32)) < 0.2).astype(np.uint8)
    )
    got = peaks_cuda.as_bool_masks(u8)
    assert got.dtype == torch.bool and got.shape == (3, 32, 7)
    assert got.data_ptr() == u8.data_ptr()
    assert torch.equal(got, u8.transpose(1, 2) != 0)


# ------------------------------------------------------------ stacked shifts


def _peaks_shift_loop(
    waveforms, shifts, density=20.0, n_fft=512, n_hop=256, f_sd=30.0,
    maxpksperframe=5, valid_samples=None, denoiser=None,
):
    """One ``find_peaks_batch`` per shift: what ``find_peaks_shifts`` must
    equal."""
    n_shifts = max(1, shifts)
    out = []
    for s in range(n_shifts):
        off = int(s / n_shifts * n_hop)
        vf = None if valid_samples is None else 1 + (valid_samples - off) // n_hop
        out.append(
            tp.find_peaks_batch(
                waveforms[:, off:], density, n_fft, n_hop, f_sd, maxpksperframe, vf,
                denoiser,
            )
        )
    return out


def _batch(with_valid):
    """(waveforms (B, T) tensor, valid_samples or None); T is a whole number
    of hops, as an 8 s query is, so shift 0 has one column more."""
    tracks = _waves(11, 3, 3.0)[:, : 93 * N_HOP]
    if not with_valid:
        return torch.from_numpy(tracks), None
    lens = [93 * N_HOP, 2 * SR + 77, SR + 4001]
    batch, valid = pad_waveform_batch([t[:n] for t, n in zip(tracks, lens)])
    return batch, valid


CASES = [(1, False), (1, True), (4, False), (4, True)]


@pytest.mark.parametrize("shifts,with_valid", CASES)
def test_stacked_shifts_masks_equal_loop(shifts, with_valid):
    batch, valid = _batch(with_valid)
    vs = None if valid is None else torch.from_numpy(valid)
    got = tp.find_peaks_shifts(batch, shifts, valid_samples=vs)
    want = _peaks_shift_loop(batch, shifts, valid_samples=vs)
    assert len(got) == len(want) == shifts
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w) and w.any()
    if shifts == 4:  # shift 0 has one column more than the others
        assert {int(g.shape[-1]) for g in got} == {
            int(got[0].shape[-1]), int(got[0].shape[-1]) - 1
        }


@pytest.mark.parametrize("shifts,with_valid", CASES)
def test_stacked_shifts_hashes_and_verdicts_equal_loop(monkeypatch, shifts, with_valid):
    tracks = _waves(11, 3, 3.0)
    names = ["a", "b", "c"]
    analyzer = AudfprintPeaks(afp_settings["audfprint"], device="cpu")
    ht = HashTable(depth=20)
    analyzer.ingest_batch(ht, names, tracks)
    dm = DeviceMatcher(ht, device="cpu")
    batch, valid = _batch(with_valid)

    hashes = analyzer.hashes_batch(batch, shifts=shifts, valid_samples=valid)
    verdicts = dm.match_waveforms(batch, shifts=shifts, valid_samples=valid)
    monkeypatch.setattr(analyzer_mod, "find_peaks_shifts", _peaks_shift_loop)
    monkeypatch.setattr(matcher_mod, "find_peaks_shifts", _peaks_shift_loop)
    loop_hashes = analyzer.hashes_batch(batch, shifts=shifts, valid_samples=valid)
    loop_verdicts = dm.match_waveforms(batch, shifts=shifts, valid_samples=valid)

    assert verdicts == loop_verdicts
    assert [v[1] for v in verdicts] == names
    for h, lh in zip(hashes, loop_hashes):
        assert len(h) > 0
        np.testing.assert_array_equal(h, lh)


def test_stacked_parts_of_unlike_lengths_equal_single():
    """Parts whose column counts differ by more than one, one of them shorter
    than the 10 columns of the forward envelope's start."""
    w = torch.from_numpy(_waves(3, 2, 2.0))
    parts = [w, w[:, : 9 * N_HOP - 5], w[:, 100 : 100 + 30 * N_HOP]]
    got = tp.find_peaks_parts(parts)
    for g, p in zip(got, parts):
        assert torch.equal(g, tp.find_peaks_batch(p))
    assert [int(g.shape[-1]) for g in got] == [63, 9, 31]

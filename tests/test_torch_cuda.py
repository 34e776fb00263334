"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

The kernels must agree with the plain prunes bit for bit (same IEEE
operations, see csrc/peaks_prune.cu). From waveforms, cuFFT and the CPU's
FFT round differently at ~1e-6, which can flip a near-tie cell: >= 0.999 of
cells must agree there, and verdicts must be equal.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from musicfpaugment_torch.afp.audfprint import AudfprintPeaks, DeviceMatcher, HashTable
from musicfpaugment_torch.afp.audfprint import peaks as tp
from musicfpaugment_torch.afp.audfprint import peaks_cuda
from musicfpaugment_torch.data.synthetic import synthetic_clean_batches
from musicfpaugment_torch.testing.parameters import afp_settings

A_DEC = tp.prune_decay(20.0, 256)
FROM_WAVEFORM_AGREEMENT = 0.999


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA prune kernels have no CPU mode")
    return torch.device("cuda")


def _logsg(seed, B, F, C):
    x = gaussian_filter(
        np.random.default_rng(seed).standard_normal((B, F, C)), sigma=(0, 2.0, 1.5)
    ).astype(np.float32) * 3
    return x - x.mean(axis=(1, 2), keepdims=True)


def _valid_frames(kind, B, C, device):
    """Per-row column counts: None, the mixed ingest lengths, the edge counts
    (0, 1 and C among them), or a stacked batch's C and C - 1."""
    if kind is None:
        return None
    if kind == "mixed":
        vals = [700, 513, 626, 90]
    elif kind == "edge":
        vals = [(0, 1, C, C // 2, C - 1, 2)[i % 6] for i in range(B)]
    else:  # "stacked": shift 0 has one column more than the other shifts
        vals = [C if i < B // 4 else C - 1 for i in range(B)]
    return torch.tensor(vals, dtype=torch.int32, device=device)


KERNEL_CASES = [
    # B, F, C, valid_frames, quantised
    (8, 256, 251, None, False),
    (4, 256, 700, "mixed", False),
    (3, 96, 40, None, False),
    # few levels: equal values in a column are common (tie order)
    (8, 256, 251, None, True),
    (3, 96, 50, None, True),
    # one column, fewer than the envelope's 10, fewer than the ring's depth
    (4, 256, 1, None, False),
    (4, 256, 7, None, False),
    (4, 256, 3, None, True),
    (6, 256, 3, "edge", False),
    # valid_frames with 0, 1 and C
    (6, 256, 60, "edge", False),
    (12, 256, 251, "edge", True),
    # other widths: one bin per lane, odd bins per lane, 16 bins per lane
    (3, 32, 50, None, True),
    (5, 32, 50, "edge", False),
    (6, 96, 60, "edge", False),
    (2, 512, 40, None, False),
    (6, 512, 40, "edge", True),
    (3, 64, 30, None, False),
    (3, 128, 30, None, True),
    # batch sizes: one row, not a multiple of the warps in a block, many
    (1, 256, 100, None, False),
    (5, 256, 100, "edge", False),
    (512, 256, 30, None, False),
    # the stacked shifts of a match batch: 251 and 250 columns
    (16, 256, 251, "stacked", False),
    (16, 256, 251, "stacked", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,C,valid,quantised", KERNEL_CASES)
def test_cuda_kernels_match_plain(cuda_device, B, F, C, valid, quantised):
    x = _logsg(B + C, B, F, C)
    if quantised:
        x = np.round(x * 2) / 2
    x = torch.from_numpy(x).to(cuda_device)
    vf = _valid_frames(valid, B, C, cuda_device)
    if vf is not None:
        x = torch.where(tp._col_mask(x.shape, vf), x, -1e30).contiguous()
    fk = peaks_cuda.forward_prune_cuda(x, A_DEC)
    fp = tp.forward_prune(x, A_DEC, 30.0, 5)
    assert torch.equal(fk, fp)
    bk = peaks_cuda.backward_prune_cuda(x, fp, A_DEC, 30.0, 5, vf)
    bp = tp.backward_prune(x, fp, A_DEC, 30.0, 5, vf)
    assert torch.equal(bk, bp)
    if C >= 10:
        assert fp.any() and bp.any()
    else:
        # the envelope starts from these very columns, so few cells pass the
        # forward test: give the backward pass marked cells of its own
        marked = torch.from_numpy(
            np.random.default_rng(C).random((B, F, C)) < 0.02
        ).to(cuda_device)
        want = tp.backward_prune(x, marked, A_DEC, 30.0, 5, vf)
        got = peaks_cuda.backward_prune_cuda(x, marked, A_DEC, 30.0, 5, vf)
        assert torch.equal(got, want) and want.any()
    # the time-major functions the path calls, the backward one on the
    # forward kernel's own bytes
    tm = x.transpose(1, 2).contiguous()
    f_tm = peaks_cuda.forward_prune_tm(tm, A_DEC)
    b_tm = peaks_cuda.backward_prune_tm(tm, f_tm, A_DEC, 30.0, 5, vf)
    assert f_tm.dtype == b_tm.dtype == torch.uint8 and int(b_tm.max()) <= 1
    assert torch.equal(peaks_cuda.as_bool_masks(f_tm), fp)
    assert torch.equal(peaks_cuda.as_bool_masks(b_tm), bp)


@pytest.mark.cuda
@pytest.mark.parametrize("F,maxpks", [(256, 5), (256, 2), (96, 5), (512, 3)])
def test_cuda_backward_takes_any_mask(cuda_device, F, maxpks):
    """More marked cells per column than rounds, on quantised values: the
    kernel re-tests the ``maxpks`` largest, lowest bin first among equals."""
    B, C = 4, 40
    x = torch.from_numpy(np.round(_logsg(F, B, F, C) * 2) / 2).to(cuda_device)
    marked = torch.from_numpy(np.random.default_rng(F).random((B, F, C)) < 0.08).to(cuda_device)
    assert int(marked.sum(dim=1).max()) > maxpks
    got = peaks_cuda.backward_prune_cuda(x, marked, A_DEC, 30.0, maxpks)
    want = tp.backward_prune(x, marked, A_DEC, 30.0, maxpks)
    assert torch.equal(got, want) and want.any()
    fk = peaks_cuda.forward_prune_cuda(x, A_DEC, 30.0, maxpks)
    assert torch.equal(fk, tp.forward_prune(x, A_DEC, 30.0, maxpks))


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_shapes(cuda_device):
    with pytest.raises(ValueError):
        peaks_cuda.forward_prune_cuda(torch.zeros((1, 100, 8), device=cuda_device), A_DEC)
    with pytest.raises(ValueError):
        peaks_cuda.forward_prune_cuda(torch.zeros((1, 544, 8), device=cuda_device), A_DEC)
    with pytest.raises(ValueError):
        peaks_cuda.forward_prune_cuda(
            torch.zeros((1, 256, 8), device=cuda_device, dtype=torch.float64), A_DEC
        )
    tm = torch.zeros((2, 8, 256), device=cuda_device)
    with pytest.raises(ValueError):  # not contiguous
        peaks_cuda.forward_prune_tm(tm.transpose(0, 1), A_DEC)
    with pytest.raises(ValueError):  # bool, not the kernels' 0/1 bytes
        peaks_cuda.backward_prune_tm(tm, tm.bool(), A_DEC)
    with pytest.raises(ValueError):  # a CPU tensor never reaches a kernel
        peaks_cuda.forward_prune_tm(tm.cpu(), A_DEC)


@pytest.mark.cuda
def test_find_peaks_batch_on_card_launches_kernels(cuda_device):
    x = np.random.default_rng(4).standard_normal((3, 3 * 8000)).astype(np.float32)
    peaks_cuda.reset_launch_counts()
    got = tp.find_peaks_batch(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    assert peaks_cuda.LAUNCHES == {"forward_prune": 1, "backward_prune": 1}
    want = tp.find_peaks_batch(torch.from_numpy(x)).numpy()
    assert (got == want).mean() >= FROM_WAVEFORM_AGREEMENT


@pytest.mark.cuda
@pytest.mark.parametrize("shifts", [1, 4])
def test_shifts_on_card_take_one_launch_pair(cuda_device, shifts):
    x = torch.from_numpy(
        np.random.default_rng(7).standard_normal((3, 40 * 256)).astype(np.float32)
    ).to(cuda_device)
    peaks_cuda.reset_launch_counts()
    got = tp.find_peaks_shifts(x, shifts)
    assert peaks_cuda.LAUNCHES == {"forward_prune": 1, "backward_prune": 1}
    assert [int(g.shape[-1]) for g in got] == [41] + [40] * (shifts - 1)
    for s, g in enumerate(got):  # equal to each shift pruned on its own
        off = int(s / shifts * 256)
        assert torch.equal(g, tp.find_peaks_batch(x[:, off:])) and g.any()


@pytest.mark.cuda
def test_match_waveforms_card_equals_cpu(cuda_device):
    tracks = next(synthetic_clean_batches(6, 12 * 8000, seed=3))
    names = [f"w{i}" for i in range(6)]
    crops = np.stack([tracks[i % 6, 8000 : 8000 + 8 * 8000] for i in range(8)])
    verdicts = []
    for dev in (cuda_device, torch.device("cpu")):
        ht = HashTable(depth=20)
        AudfprintPeaks(afp_settings["audfprint"], device=dev).ingest_batch(ht, names, tracks)
        verdicts.append(DeviceMatcher(ht, device=dev).match_waveforms(crops, shifts=2))
    assert [v[:2] for v in verdicts[0]] == [v[:2] for v in verdicts[1]]
    assert [v[1] for v in verdicts[0]] == [names[i % 6] for i in range(8)]

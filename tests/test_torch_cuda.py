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


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,C,mixed", [(8, 256, 251, False), (4, 256, 700, True), (3, 96, 40, False)])
def test_cuda_kernels_match_plain(cuda_device, B, F, C, mixed):
    x = torch.from_numpy(_logsg(B + C, B, F, C)).to(cuda_device)
    vf = None
    if mixed:
        vf = torch.tensor([700, 513, 626, 90], dtype=torch.int32, device=cuda_device)
        x = torch.where(tp._col_mask(x.shape, vf), x, -1e30).contiguous()
    fk = peaks_cuda.forward_prune_cuda(x, A_DEC)
    fp = tp.forward_prune(x, A_DEC, 30.0, 5)
    assert torch.equal(fk, fp) and fp.any()
    bk = peaks_cuda.backward_prune_cuda(x, fp, A_DEC, 30.0, 5, vf)
    bp = tp.backward_prune(x, fp, A_DEC, 30.0, 5, vf)
    assert torch.equal(bk, bp) and bp.any()


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


@pytest.mark.cuda
def test_find_peaks_batch_on_card_launches_kernels(cuda_device):
    x = np.random.default_rng(4).standard_normal((3, 3 * 8000)).astype(np.float32)
    peaks_cuda.reset_launch_counts()
    got = tp.find_peaks_batch(torch.from_numpy(x).to(cuda_device)).cpu().numpy()
    assert peaks_cuda.LAUNCHES == {"forward_prune": 1, "backward_prune": 1}
    want = tp.find_peaks_batch(torch.from_numpy(x)).numpy()
    assert (got == want).mean() >= FROM_WAVEFORM_AGREEMENT


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

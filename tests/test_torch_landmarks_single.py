"""Port parity: the single-example hashing chain of
musicfpaugment_torch.afp.audfprint.landmarks (``extract_peaks``,
``pair_landmarks``, ``pair_hashes``, ``landmarks_to_hashes``,
``hashes_from_mask``, ``_lookahead``) against the JAX package's, from the
same numpy masks. Everything is integer arithmetic in the same order, so
every output array, padding rows included, must be bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_tpu.afp.audfprint import landmarks as jlm
from musicfpaugment_torch.afp import audfprint as taf
from musicfpaugment_torch.afp.audfprint import landmarks as tlm

from torch_port_helpers import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

# (seed, F, C, density, max_peaks, max_hashes): sparse and dense masks, a
# peak budget that truncates, a hash budget that truncates, an empty mask
CASES = [
    (0, 256, 63, 0.01, 384, 1152),
    (1, 256, 200, 0.004, 1024, 3072),
    (2, 64, 40, 0.05, 128, 1024),
    (3, 256, 120, 0.01, 640, 256),
    (4, 32, 16, 0.0, 128, 384),
]


def _mask(seed, F, C, density):
    """A random sparse mask with <= 5 peaks per column."""
    r = np.random.default_rng(seed)
    m = r.random((F, C)) < density
    return m & (np.cumsum(m, axis=0) <= 5)


def _eq(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,F,C,density,max_peaks,max_hashes", CASES)
def test_extract_and_pair_bit_identical(seed, F, C, density, max_peaks, max_hashes):
    mask = _mask(seed, F, C, density)
    t_peaks = tlm.extract_peaks(torch.from_numpy(mask), max_peaks)
    j_peaks = jlm.extract_peaks(jnp.asarray(mask), max_peaks)
    for a, b in zip(t_peaks, j_peaks):
        _eq(a, b)
    for window in (320, 17):
        t_lm, t_sel = tlm.pair_landmarks(*t_peaks, window=window)
        j_lm, j_sel = jlm.pair_landmarks(*j_peaks, window=window)
        _eq(t_lm, j_lm)
        _eq(t_sel, j_sel)
        _eq(tlm.landmarks_to_hashes(t_lm), jlm.landmarks_to_hashes(j_lm))
        for a, b in zip(tlm.pair_hashes(*t_peaks, window=window),
                        jlm.pair_hashes(*j_peaks, window=window)):
            _eq(a, b)
        # the fused hash equals the landmark tensor's packing where selected
        th = tlm.landmarks_to_hashes(t_lm)
        _, t_h, _ = tlm.pair_hashes(*t_peaks, window=window)
        assert torch.equal(th[..., 1][t_sel], t_h[t_sel])


@pytest.mark.parametrize("seed,F,C,density,max_peaks,max_hashes", CASES)
def test_hashes_from_mask_bit_identical(seed, F, C, density, max_peaks, max_hashes):
    mask = _mask(seed, F, C, density)
    t_th, t_v = tlm.hashes_from_mask(torch.from_numpy(mask), max_peaks, max_hashes)
    j_th, j_v = jlm.hashes_from_mask(jnp.asarray(mask), max_peaks, max_hashes)
    _eq(t_th, j_th)  # padding rows included
    _eq(t_v, j_v)
    np.testing.assert_array_equal(
        taf.hashes_from_mask_np(mask), jlm.hashes_from_mask_np(mask)
    )
    if mask.sum() <= max_peaks and seed != 3:  # no budget binds: the loop oracle
        np.testing.assert_array_equal(t_th.numpy()[t_v.numpy()], tlm.hashes_from_mask_np(mask))


def test_single_example_equals_the_batched_hasher():
    """One mask through ``hashes_from_mask`` and the same mask as a batch of
    one through ``hashes_from_masks_batched``: the same valid rows."""
    masks = np.stack([_mask(s, 256, 100, 0.008) for s in range(3)])
    max_peaks = -(-5 * 100 // 128) * 128
    th_b, v_b = tlm.hashes_from_masks_batched(
        torch.from_numpy(masks), max_peaks, max_peaks * tlm.MAXPAIRSPERPEAK
    )
    for b in range(3):
        th, v = taf.hashes_from_mask(
            torch.from_numpy(masks[b]), max_peaks, max_peaks * tlm.MAXPAIRSPERPEAK
        )
        assert v.sum() > 0
        assert torch.equal(th[v], th_b[b][v_b[b]])


@pytest.mark.parametrize("window,fill", [(8, -1), (1, 0), (40, 7)])
def test_lookahead_bit_identical(window, fill):
    r = np.random.default_rng(window)
    x = r.integers(0, 4096, (3, 25)).astype(np.int32)
    got = tlm._lookahead(torch.from_numpy(x), window, fill)
    want = jlm._lookahead(jnp.asarray(x), window, fill)
    _eq(got, want)
    assert float(got[0, 0, 0]) == float(x[0, 1])

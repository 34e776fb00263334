"""Port parity: musicfpaugment_torch.afp.audfprint.landmarks against the JAX
package, from the same numpy masks. Hashes are integer arithmetic, so the
valid (time, hash) rows and their validity must be bit-identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_tpu.afp.audfprint import landmarks as jlm
from musicfpaugment_torch.afp.audfprint import landmarks as tlm


def _masks(seed, B, F, C, density):
    """Random sparse masks with <= 5 peaks per column."""
    r = np.random.default_rng(seed)
    m = r.random((B, F, C)) < density
    cum = np.cumsum(m, axis=1)
    return m & (cum <= 5)


def _valid_rows(th, valid):
    return [th[b][valid[b]] for b in range(th.shape[0])]


@pytest.mark.parametrize("seed,C,density", [(0, 63, 0.01), (1, 200, 0.004), (2, 40, 0.0)])
def test_hashes_from_masks_batched_bit_identical(seed, C, density):
    masks = _masks(seed, 3, 256, C, density)
    max_peaks = -(-5 * C // 128) * 128
    max_hashes = max_peaks * tlm.MAXPAIRSPERPEAK
    th_t, v_t = tlm.hashes_from_masks_batched(
        torch.from_numpy(masks), max_peaks=max_peaks, max_hashes=max_hashes
    )
    th_j, v_j = jlm.hashes_from_masks_batched(
        jnp.asarray(masks), max_peaks=max_peaks, max_hashes=max_hashes
    )
    th_t, v_t = th_t.numpy(), v_t.numpy()
    th_j, v_j = np.asarray(th_j), np.asarray(v_j)
    assert th_t.dtype == np.int32 and th_t.shape == th_j.shape
    np.testing.assert_array_equal(v_t, v_j)
    for a, b, m in zip(_valid_rows(th_t, v_t), _valid_rows(th_j, v_j), masks):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, tlm.hashes_from_mask_np(m))


def test_hashes_overflowing_peak_budget_match_jax():
    """More peaks than max_peaks: both keep the first max_peaks in
    (column, bin) order."""
    masks = _masks(5, 2, 64, 100, 0.05)
    th_t, v_t = tlm.hashes_from_masks_batched(torch.from_numpy(masks), 128, 384)
    th_j, v_j = jlm.hashes_from_masks_batched(jnp.asarray(masks), 128, 384)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    for a, b in zip(_valid_rows(th_t.numpy(), v_t.numpy()), _valid_rows(np.asarray(th_j), np.asarray(v_j))):
        np.testing.assert_array_equal(a, b)


def _th(seed, B, K):
    r = np.random.default_rng(seed)
    t = r.integers(0, 40, (B, K)).astype(np.int32)
    h = r.integers(0, 6, (B, K)).astype(np.int32)  # many duplicate pairs
    v = r.random((B, K)) < 0.7
    return t, h, v


def test_sort_dedup_hashes_bit_identical():
    t, h, v = _th(3, 4, 300)
    got = tlm.sort_dedup_hashes(*(torch.from_numpy(a) for a in (t, h, v)))
    want = jlm.sort_dedup_hashes(*(jnp.asarray(a) for a in (t, h, v)))
    gt, gh, gv = (a.numpy() for a in got)
    wt, wh, wv = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gt[gv], wt[wv])
    np.testing.assert_array_equal(gh[gv], wh[wv])
    # invalid entries sort last
    n_valid = v.sum(axis=1)
    for b in range(4):
        assert not gv[b, n_valid[b]:].any()


@pytest.mark.parametrize("out_len", [0, 64, 512])
def test_compact_valid_first_bit_identical(out_len):
    t, h, v = _th(4, 3, 300)
    got = tlm.compact_valid_first(*(torch.from_numpy(a) for a in (t, h, v)), out_len=out_len)
    want = jlm.compact_valid_first(*(jnp.asarray(a) for a in (t, h, v)), out_len=out_len)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

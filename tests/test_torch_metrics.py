"""Peak-mask Precision / Recall / F1 and PSNR, port against JAX on seeded
masks (1e-6 on the ratios, 1e-4 dB on PSNR)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from musicfpaugment_torch.testing import metrics as tm
from musicfpaugment_torch.train import losses as tl
from musicfpaugment_tpu.testing import metrics as jm
from musicfpaugment_tpu.train import losses as jl


def _masks(seed, shape=(3, 64, 47), density=0.03, overlap=0.6):
    """A ground-truth mask and a prediction sharing about ``overlap`` of it,
    with peaks on the borders."""
    r = np.random.default_rng(seed)
    gt = r.random(shape) < density
    pred = (gt & (r.random(shape) < overlap)) | (r.random(shape) < density / 2)
    gt[..., 0, 0] = gt[..., -1, -1] = pred[..., 0, 1] = pred[..., -1, -1] = True
    return pred, gt


@pytest.mark.parametrize("tolerance", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_metrics_match_jax(tolerance, seed):
    pred, gt = _masks(seed)
    for tcls, jcls in ((tm.Recall, jm.Recall), (tm.Precision, jm.Precision), (tm.F1score, jm.F1score)):
        got = tcls(tolerance)(pred[:1], gt[:1])
        want = jcls(tolerance)(pred[:1], gt[:1])
        assert isinstance(got, float) and want > 0.0
        assert abs(got - want) <= 1e-6, (tcls.__name__, got, want)
        # tensors are taken as well as arrays, and ``forward`` is the call
        assert tcls(tolerance).forward(torch.from_numpy(pred[:1]), torch.from_numpy(gt[:1])) == got


@pytest.mark.parametrize("tolerance", [0, 1])
def test_tolerance_sum_is_the_zero_padded_box_sum(tolerance):
    pred, _ = _masks(2, shape=(2, 9, 7), density=0.3)
    got = tm._tolerance_sum(torch.from_numpy(pred).float(), tolerance).numpy()
    want = np.asarray(jm._tolerance_sum(jnp.asarray(pred, jnp.float32), tolerance))
    np.testing.assert_array_equal(got, want)
    k = tolerance
    padded = np.pad(pred.astype(np.float32), ((0, 0), (k, k), (k, k)))
    loop = sum(padded[:, i : i + 9, j : j + 7] for i in range(2 * k + 1) for j in range(2 * k + 1))
    np.testing.assert_array_equal(got, loop)


@pytest.mark.parametrize("empty", ["prediction", "ground_truth", "both"])
def test_empty_masks_score_zero_as_in_jax(empty):
    pred, gt = _masks(3)
    if empty in ("prediction", "both"):
        pred = np.zeros_like(pred)
    if empty in ("ground_truth", "both"):
        gt = np.zeros_like(gt)
    for tcls, jcls in ((tm.Recall, jm.Recall), (tm.Precision, jm.Precision), (tm.F1score, jm.F1score)):
        assert tcls()(pred, gt) == jcls()(pred, gt) == 0.0
    got = tm.batch_peak_metrics(pred, gt, reduce=False)
    want = jm.batch_peak_metrics(pred, gt, reduce=False)
    for key in ("precision", "recall", "f1"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("tolerance", [0, 1])
def test_batched_metrics_match_jax_and_the_per_example_calls(tolerance):
    pred, gt = _masks(4, shape=(5, 64, 47))
    pred[2], gt[3] = False, False  # one empty prediction, one empty ground truth
    got = tm.batch_peak_metrics(pred, gt, tolerance, reduce=False)
    want = jm.batch_peak_metrics(pred, gt, tolerance, reduce=False)
    singles = {"precision": tm.Precision(tolerance), "recall": tm.Recall(tolerance),
               "f1": tm.F1score(tolerance)}
    for key, metric in singles.items():
        assert got[key].shape == (5,)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=1e-6)
        each = [metric(pred[i : i + 1], gt[i : i + 1]) for i in range(5)]
        np.testing.assert_allclose(got[key].numpy(), each, rtol=0, atol=1e-6)
    means = tm.batch_peak_metrics(pred, gt, tolerance)
    jmeans = jm.batch_peak_metrics(pred, gt, tolerance)
    for key in singles:
        assert isinstance(means[key], float) and abs(means[key] - jmeans[key]) <= 1e-6


def test_psnr_matches_jax():
    r = np.random.default_rng(5)
    target = r.random((4, 33, 21)).astype(np.float32)
    pred = (target + 0.05 * r.standard_normal(target.shape)).astype(np.float32)
    pred[1] = target[1]  # an exact row: the mse floor of 1e-12
    got = float(tm.psnr(pred, target))
    assert abs(got - float(jm.psnr(pred, target))) <= 1e-4
    assert abs(float(tl.psnr(torch.from_numpy(pred), torch.from_numpy(target)))
               - float(jl.psnr(jnp.asarray(pred), jnp.asarray(target)))) <= 1e-4
    rows = tm.batch_psnr(pred, target)
    assert rows.shape == (4,)
    np.testing.assert_allclose(rows.numpy(), np.asarray(jm.batch_psnr(pred, target)), rtol=0, atol=1e-4)
    for i in range(4):  # each row scored like psnr on its own
        assert abs(float(rows[i]) - float(tm.psnr(pred[i : i + 1], target[i : i + 1]))) <= 1e-4
    assert float(rows[1]) > 100.0 and np.isfinite(rows.numpy()).all()

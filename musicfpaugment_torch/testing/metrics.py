"""Peak-mask Precision / Recall / F1 and PSNR (port of
musicfpaugment_tpu/testing/metrics.py).

With a tolerance window ``w``, ``recall = sum(boxsum_w(predicted) * gt) /
sum(gt)`` and symmetrically for precision: the same sums as a loop over peak
coordinates, batched. ``tolerance=0`` is exact peak matching, uniformly up
to the borders; ``tolerance=1`` accepts a peak within one time-frequency bin.
Inputs are arrays or tensors; a tensor stays on its device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from musicfpaugment_torch.train.losses import psnr as _psnr


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def psnr(pred, target) -> torch.Tensor:
    """Micro-averaged PSNR of the two whole tensors."""
    return _psnr(_f32(pred), _f32(target))


def _tolerance_sum(source: torch.Tensor, tolerance: int) -> torch.Tensor:
    """Zero-padded box sum of ``source`` over a (2*tol+1)^2 window on its
    last two axes (tol=0: identity)."""
    if tolerance == 0:
        return source
    k = 2 * tolerance + 1
    planes = source.reshape((-1, 1) + tuple(source.shape[-2:]))
    summed = F.avg_pool2d(planes, k, stride=1, padding=k // 2, divisor_override=1)
    return summed.reshape(source.shape)


class Recall:
    """Fraction of ground-truth peaks retrieved by the prediction."""

    def __init__(self, tolerance: int = 0) -> None:
        self.tolerance = tolerance

    def __call__(self, predicted, gt) -> float:
        predicted, gt = _f32(predicted), _f32(gt)
        n_gt = float(gt.sum())
        if n_gt == 0:
            return 0.0
        return float((_tolerance_sum(predicted, self.tolerance) * gt).sum()) / n_gt

    forward = __call__


class Precision:
    """Fraction of predicted peaks that hit a ground-truth peak."""

    def __init__(self, tolerance: int = 0) -> None:
        self.tolerance = tolerance

    def __call__(self, predicted, gt) -> float:
        predicted, gt = _f32(predicted), _f32(gt)
        n_pred = float(predicted.sum())
        if n_pred == 0:
            return 0.0
        return float((_tolerance_sum(gt, self.tolerance) * predicted).sum()) / n_pred

    forward = __call__


class F1score:
    """Harmonic mean of Precision and Recall."""

    def __init__(self, tolerance: int = 0) -> None:
        self.prec = Precision(tolerance)
        self.rec = Recall(tolerance)

    def __call__(self, predicted, gt) -> float:
        p = self.prec(predicted, gt)
        r = self.rec(predicted, gt)
        if math.isclose(p + r, 0.0):
            return 0.0
        return float(2.0 * (p * r) / (p + r))

    forward = __call__


def batch_peak_metrics(predicted, gt, tolerance: int = 0, reduce: bool = True) -> dict:
    """Batched (B, F, C) masks -> {precision, recall, f1} in one pass.
    ``reduce=False`` returns the per-example (B,) tensors instead of batch
    means (callers that accumulate across uneven chunks need sums, not means
    of means)."""
    predicted, gt = _f32(predicted), _f32(gt)
    tol_pred = _tolerance_sum(predicted, tolerance)
    tol_gt = _tolerance_sum(gt, tolerance)
    axes = tuple(range(1, predicted.ndim))
    n_gt = gt.sum(dim=axes)
    n_pred = predicted.sum(dim=axes)
    zero = torch.zeros_like(n_gt)
    recall = torch.where(n_gt > 0, (tol_pred * gt).sum(dim=axes) / n_gt, zero)
    precision = torch.where(n_pred > 0, (tol_gt * predicted).sum(dim=axes) / n_pred, zero)
    denom = precision + recall
    f1 = torch.where(
        denom > 0, 2 * precision * recall / torch.where(denom > 0, denom, 1.0), zero
    )
    if not reduce:
        return {"precision": precision, "recall": recall, "f1": f1}
    return {
        "precision": float(precision.mean()),
        "recall": float(recall.mean()),
        "f1": float(f1.mean()),
    }


def batch_psnr(pred, target) -> torch.Tensor:
    """Per-example PSNR (B,): each row scored like :func:`psnr` on its own."""
    pred, target = _f32(pred), _f32(target)
    axes = tuple(range(1, pred.ndim))
    data_range = torch.maximum(pred, target).amax(dim=axes) - torch.minimum(pred, target).amin(dim=axes)
    mse = torch.mean((pred - target) ** 2, dim=axes)
    return 10.0 * torch.log10(data_range**2 / torch.clamp(mse, min=1e-12))
